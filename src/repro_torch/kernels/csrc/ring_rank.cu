// One rank's share of the drop-masked ring round, between real transfers,
// for Hopper (sm_90a).
//
// Replaces, on the collective path, the per-device arithmetic of
// src/repro/kernels/rps_ring.py::ring_bucket_fused (body _make_ring_kernel;
// its interpret schedule _ring_schedule_jax): on rank i of an n-rank ring
// over an owner-major (S, W) table (S = k * n, rank i owning rows
// [i * k, (i + 1) * k)), the reduce-scatter takes n hops and the all-gather
// n landings, with the transfers in between made by core/comm.py's ring
// shift. ring.cu computes the same round for every rank at once on one
// card; this file computes one rank's share of it.
//
// ring_rank_hop: hop t = 0 .. n - 1 works on chunk c = (i - 1 - t) mod n,
// rows [c * k, (c + 1) * k), every element of the chunk (k rows of W):
//
//   c_e  = cast_acc(x) * cast_acc(rs[row])
//          x = src[row, col] (the payload, or the EF send / a corrupted
//          offer on a linear wire), or float(q[row, col]) * scale[row] on
//          the int8 wire (the decoded f32 value, not rounded to the
//          payload type: the collective reference decodes it so)
//   acc  = c_e                              (t = 0: no leading zero)
//        = cast_acc(recv + c_e)             (t > 0; on the int8 wire recv
//          is float(q_recv) * scale_recv[r], decoded before the add)
//   last hop (t = n - 1, c = i, the owner): out = cast_payload(
//          cast_acc(acc / cast_acc(div[row])))
//   other hops, levels = 0: out = acc, in the accumulation type;
//          levels > 0: each row re-encoded onto {-levels, ..., levels}:
//          D = (max|acc| over the row > 0 ? max|acc| : 1) / levels,
//          q = clip(rint(acc / D)), sent as int8 q and f32 D.
//
// ring_rank_land: a landed chunk c of the averaged payload written into the
// output with the all-gather select fused:
//   out[row] = ag[row] ? cur[r] : (renorm ? blocks[row] : 0)
// -- the fallback is read from the rank's own table where ag dropped the
// block and never copied beforehand, as in the TPU kernel.
//
// Bit for bit equal to the plain versions (kernels/ref.py::ring_rank_hop_ref
// and ring_rank_land_ref): every multiply, divide and add is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fdiv_rn, __fadd_rn), so nothing
// is contracted into a multiply-add; rintf rounds half to even as
// torch.round does; the row max is exact and independent of order, a NaN
// in the row making it NaN (as torch.amax does) and D = 1 / levels; a NaN
// quotient encodes as 0, as the int8 cast of torch.clamp's NaN goes.
//
// What bounds it: bytes. A hop reads the received partial and its own
// chunk once and writes the new partial once (k * W * (recv + src + out
// bytes), plus k masks, scales and divisors), with one add and one multiply
// an element; a landing reads the chunk and writes it (the fallback read
// only where ag dropped the block). At rps-100m's largest bucket chunk on
// four ranks (one row of 7,077,888 f32 columns) a hop moves 84.9 MB, 25 us
// at an H100 SXM's 3.35 TB/s (data sheet, 700 W).
//
// What the design does about it (the first, simple form):
//   - the linear hops and the landings: one thread block of 256 threads per
//     row on grid.y and column tiles on grid.x, each thread walking its
//     columns with a grid stride, neighbouring threads on neighbouring
//     columns so a warp's loads coalesce; the row's mask, scale and divisor
//     are read once per block;
//   - the re-encoding hops (levels > 0): one block of 1,024 threads per row.
//     The encode needs max|acc| over the whole row before any column of it
//     can be encoded, so the block makes two passes over the row: the first
//     finds the max (a warp shuffle, then one word per warp in shared
//     memory), the second computes acc again from the same inputs and
//     encodes it. Nothing but the int8 partial and its scale is written;
//     a row has one block, so a wide row runs on one SM (a later redesign
//     would split it across a cluster, as ring_q.cu does).
// Overlapping hop t's transfer with hop t - 1's add (the TPU kernel's
// double buffer) is left to a later redesign. Any W >= 1, any k >= 1; the
// kernels allocate nothing and run on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ring_common.cuh"

namespace repro_torch {
namespace {

using ring::load_mask;
using ring::round_acc;

constexpr int kHopThreads = 256;
constexpr int kRowThreads = 1024;
// column tiles of one row on grid.x; a thread walks the rest with a stride
constexpr int64_t kMaxTiles = 2048;

// the contribution of one element before the mask: an int8 payload times
// its row scale (f32), or a payload value
__device__ __forceinline__ float contrib_val(int8_t q, float sc) {
  return __fmul_rn(static_cast<float>(q), sc);
}
template <typename T>
__device__ __forceinline__ float contrib_val(T x, float) {
  return to_float(x);
}

// the received partial of one element: int8 times its row scale, or a value
// of the accumulation type
__device__ __forceinline__ float recv_val(int8_t q, float sc) {
  return __fmul_rn(static_cast<float>(q), sc);
}
template <typename T>
__device__ __forceinline__ float recv_val(T x, float) {
  return to_float(x);
}

// the larger of two non-negative floats, NaN winning as torch.amax lets it
// (on their bits a sign-cleared NaN lies above +inf; fmaxf would drop it)
__device__ __forceinline__ float abs_max(float a, float b) {
  return __uint_as_float(max(__float_as_uint(a), __float_as_uint(b)));
}

// rint(a / D) clipped to +-levels, a NaN quotient to 0
__device__ __forceinline__ int encode(float a, float delta, float levels) {
  const float q = rintf(__fdiv_rn(a, delta));
  return q != q ? 0 : static_cast<int>(fminf(fmaxf(q, -levels), levels));
}

// C: the contribution table's element (float, bf16 or int8_t); A: the
// accumulation type; R: the received partial's element (A or int8_t); O:
// the output's element (A on a middle hop, the payload type on the last).
template <typename C, typename A, typename R, typename O>
__global__ void __launch_bounds__(kHopThreads)
    ring_rank_hop_kernel(const C* __restrict__ src,
                         const float* __restrict__ src_scale, const void* rs,
                         DType rs_dtype, const R* __restrict__ recv,
                         const float* __restrict__ recv_scale,
                         const float* __restrict__ div, O* __restrict__ out,
                         int64_t chunk, int64_t k, int64_t W, bool last) {
  const int64_t r = blockIdx.y;
  const int64_t row = chunk * k + r;
  const float m = round_acc<A>(load_mask(rs, rs_dtype, row));
  const float sc = src_scale != nullptr ? src_scale[row] : 1.0f;
  const float rsc = recv_scale != nullptr ? recv_scale[r] : 1.0f;
  const float dv = last ? round_acc<A>(div[row]) : 1.0f;
  const C* s = src + row * W;
  const bool has_recv = recv != nullptr;
  const R* rv = has_recv ? recv + r * W : nullptr;
  O* o = out + r * W;
  for (int64_t col = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       col < W; col += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float c = __fmul_rn(round_acc<A>(contrib_val(s[col], sc)), m);
    float acc = has_recv ? round_acc<A>(__fadd_rn(recv_val(rv[col], rsc), c))
                         : c;
    if (last) acc = round_acc<A>(__fdiv_rn(acc, dv));
    o[col] = from_float<O>(acc);
  }
}

// A re-encoding hop on the int8 wire (accumulation in f32): one block per
// row, two passes over it (the row's max, then the encode).
__global__ void __launch_bounds__(kRowThreads)
    ring_rank_requant_kernel(const int8_t* __restrict__ src,
                             const float* __restrict__ src_scale,
                             const void* rs, DType rs_dtype,
                             const int8_t* __restrict__ recv,
                             const float* __restrict__ recv_scale,
                             int8_t* __restrict__ out,
                             float* __restrict__ out_scale, int64_t chunk,
                             int64_t k, int64_t W, float levels) {
  __shared__ float s_max[kRowThreads / 32];
  const int64_t r = blockIdx.x;
  const int64_t row = chunk * k + r;
  const float m = load_mask(rs, rs_dtype, row);
  const float sc = src_scale[row];
  const float rsc = recv != nullptr ? recv_scale[r] : 1.0f;
  const int8_t* s = src + row * W;
  const bool has_recv = recv != nullptr;
  const int8_t* rv = has_recv ? recv + r * W : nullptr;
  const auto acc_at = [&](int64_t col) {
    const float c = __fmul_rn(contrib_val(s[col], sc), m);
    return has_recv ? __fadd_rn(recv_val(rv[col], rsc), c) : c;
  };
  float local = 0.0f;
  for (int64_t col = threadIdx.x; col < W; col += blockDim.x)
    local = abs_max(local, fabsf(acc_at(col)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local = abs_max(local, __shfl_xor_sync(0xffffffffu, local, off));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) s_max[warp] = local;
  __syncthreads();
  float amax = 0.0f;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w)
    amax = abs_max(amax, s_max[w]);
  const float delta = __fdiv_rn(amax > 0.0f ? amax : 1.0f, levels);
  int8_t* o = out + r * W;
  for (int64_t col = threadIdx.x; col < W; col += blockDim.x)
    o[col] = static_cast<int8_t>(encode(acc_at(col), delta, levels));
  if (threadIdx.x == 0) out_scale[r] = delta;
}

template <typename T>
__global__ void __launch_bounds__(kHopThreads)
    ring_rank_land_kernel(const T* __restrict__ cur, const void* ag,
                          DType ag_dtype, const T* __restrict__ blocks,
                          T* __restrict__ out, int64_t chunk, int64_t k,
                          int64_t W, bool renorm) {
  const int64_t r = blockIdx.y;
  const int64_t row = chunk * k + r;
  const bool keep = load_mask(ag, ag_dtype, row) != 0.0f;
  const T* c = cur + r * W;
  const T* b = blocks + row * W;
  T* o = out + row * W;
  const T zero = from_float<T>(0.0f);
  for (int64_t col = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       col < W; col += static_cast<int64_t>(gridDim.x) * blockDim.x)
    o[col] = keep ? c[col] : (renorm ? b[col] : zero);
}

dim3 row_grid(int64_t k, int64_t W) {
  int64_t tiles = (W + kHopThreads - 1) / kHopThreads;
  if (tiles > kMaxTiles) tiles = kMaxTiles;
  return dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(k));
}

template <typename C, typename A, typename R, typename O>
void hop_typed(const void* src, const float* src_scale, const void* rs,
               DType rs_dtype, const void* recv, const float* recv_scale,
               const float* div, void* out, int64_t chunk, int64_t k,
               int64_t W, bool last, cudaStream_t stream) {
  ring_rank_hop_kernel<C, A, R, O><<<row_grid(k, W), kHopThreads, 0,
                                     stream>>>(
      static_cast<const C*>(src), src_scale, rs, rs_dtype,
      static_cast<const R*>(recv), recv_scale, div, static_cast<O*>(out),
      chunk, k, W, last);
}

// the output type: the accumulation type on a middle hop, the payload type
// on the last
template <typename C, typename A, typename R>
void hop_out(DType out_dtype, const void* src, const float* src_scale,
             const void* rs, DType rs_dtype, const void* recv,
             const float* recv_scale, const float* div, void* out,
             int64_t chunk, int64_t k, int64_t W, bool last,
             cudaStream_t stream) {
  if (out_dtype == DType::kBF16)
    hop_typed<C, A, R, __nv_bfloat16>(src, src_scale, rs, rs_dtype, recv,
                                      recv_scale, div, out, chunk, k, W,
                                      last, stream);
  else
    hop_typed<C, A, R, float>(src, src_scale, rs, rs_dtype, recv, recv_scale,
                              div, out, chunk, k, W, last, stream);
}

template <typename C, typename A>
void hop_recv(DType recv_dtype, DType out_dtype, const void* src,
              const float* src_scale, const void* rs, DType rs_dtype,
              const void* recv, const float* recv_scale, const float* div,
              void* out, int64_t chunk, int64_t k, int64_t W, bool last,
              cudaStream_t stream) {
  if (recv_dtype == DType::kI8)
    hop_out<C, A, int8_t>(out_dtype, src, src_scale, rs, rs_dtype, recv,
                          recv_scale, div, out, chunk, k, W, last, stream);
  else
    hop_out<C, A, A>(out_dtype, src, src_scale, rs, rs_dtype, recv,
                     recv_scale, div, out, chunk, k, W, last, stream);
}

template <typename C>
void hop_acc(DType acc_dtype, DType recv_dtype, DType out_dtype,
             const void* src, const float* src_scale, const void* rs,
             DType rs_dtype, const void* recv, const float* recv_scale,
             const float* div, void* out, int64_t chunk, int64_t k, int64_t W,
             bool last, cudaStream_t stream) {
  if (acc_dtype == DType::kBF16)
    hop_recv<C, __nv_bfloat16>(recv_dtype, out_dtype, src, src_scale, rs,
                               rs_dtype, recv, recv_scale, div, out, chunk,
                               k, W, last, stream);
  else
    hop_recv<C, float>(recv_dtype, out_dtype, src, src_scale, rs, rs_dtype,
                       recv, recv_scale, div, out, chunk, k, W, last,
                       stream);
}

}  // namespace

void ring_rank_hop_launch(const void* src, DType src_dtype,
                          const float* src_scale, const void* rs,
                          DType rs_dtype, const void* recv, DType recv_dtype,
                          const float* recv_scale, const float* div,
                          void* out, DType out_dtype, float* out_scale,
                          DType acc_dtype, int levels, bool last,
                          int64_t chunk, int64_t k, int64_t W,
                          cudaStream_t stream) {
  if (levels > 0 && !last) {  // the binding admits only int8 here
    ring_rank_requant_kernel<<<static_cast<unsigned>(k), kRowThreads, 0,
                               stream>>>(
        static_cast<const int8_t*>(src), src_scale, rs, rs_dtype,
        static_cast<const int8_t*>(recv), recv_scale,
        static_cast<int8_t*>(out), out_scale, chunk, k, W,
        static_cast<float>(levels));
    return;
  }
  switch (src_dtype) {
    case DType::kI8:  // the binding sums int8 in f32
      return hop_acc<int8_t>(DType::kF32, recv_dtype, out_dtype, src,
                             src_scale, rs, rs_dtype, recv, recv_scale, div,
                             out, chunk, k, W, last, stream);
    case DType::kBF16:
      return hop_acc<__nv_bfloat16>(acc_dtype, recv_dtype, out_dtype, src,
                                    src_scale, rs, rs_dtype, recv,
                                    recv_scale, div, out, chunk, k, W, last,
                                    stream);
    default:  // the binding admits only f32, bf16 and int8
      return hop_acc<float>(acc_dtype, recv_dtype, out_dtype, src, src_scale,
                            rs, rs_dtype, recv, recv_scale, div, out, chunk,
                            k, W, last, stream);
  }
}

void ring_rank_land_launch(const void* cur, DType dtype, const void* ag,
                           DType ag_dtype, const void* blocks, void* out,
                           bool renorm, int64_t chunk, int64_t k, int64_t W,
                           cudaStream_t stream) {
  if (dtype == DType::kBF16) {
    ring_rank_land_kernel<__nv_bfloat16><<<row_grid(k, W), kHopThreads, 0,
                                           stream>>>(
        static_cast<const __nv_bfloat16*>(cur), ag, ag_dtype,
        static_cast<const __nv_bfloat16*>(blocks),
        static_cast<__nv_bfloat16*>(out), chunk, k, W, renorm);
  } else {  // the binding admits only f32 and bf16
    ring_rank_land_kernel<float><<<row_grid(k, W), kHopThreads, 0, stream>>>(
        static_cast<const float*>(cur), ag, ag_dtype,
        static_cast<const float*>(blocks), static_cast<float*>(out), chunk,
        k, W, renorm);
  }
}

}  // namespace repro_torch
