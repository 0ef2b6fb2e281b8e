// The drop-masked ring round that re-encodes its partial on every hop, for
// all n stacked ranks, for Hopper (sm_90a).
//
// Replaces the levels > 0 variant of src/repro/kernels/rps_ring.py::
// ring_bucket_fused (body _make_ring_kernel): the contributions come from
// an int8 table q with one f32 scale per (g, rank, block) row, as in
// ring.cu's has_enc round, and every reduce-scatter hop re-encodes the
// running f32 partial onto the int8 grid (per-row amax / levels, round half
// to even, clip) and decodes it before the next add. For a group
// (G, n, s, d) in block order, block j owned by o = j % n:
//
//   c[r]  = float(cast_T(float(q[g,r,j]) * scale[g,r,j])) * rs[g,r,j]
//   acc   = c[o+1];  for t = 2..n:  acc = requant(acc) + c[(o+t) % n]
//   requant(a) = clip(rint(a / D), -levels, levels) * D,
//           D = (max|a| over the row's d > 0 ? max|a| : 1) / levels
//   out[g,i,j] = ag[g,i,j] ? cast_T(acc / div[g,j])
//                          : (renorm ? stack[g,i,j] : 0)
//
// -- what the JAX package's global path computes for the simulator on the
// int8 wire (rps.py: fake-quant send, ring_global_sums with the codec,
// divide, cast, select). T is the payload type (f32, bf16); the sum is in
// f32. Bit for bit equal to the plain version (kernels/ref.py::
// ring_round_ref with enc= and levels=): every multiply, divide and add is
// an explicit round-to-nearest intrinsic, so no multiply-add is
// contracted; rintf rounds half to even as torch.round does; the row max
// is exact.
//
// What bounds it: bytes. The least traffic is the int8 table read once, the
// output written once and the fallback blocks read where ag dropped them
// (at rps-100m's largest group (3, 16, 16, 1769472) f32 about 7.3 GB, 2.2
// ms at an H100 SXM's 3.35 TB/s, data sheet, 700 W).
//
// What the design does about it (the first, simple form): the re-encode
// needs max|acc| over a whole row (up to 1.77 M columns, 7 MB) before any
// column of it can be encoded, n - 1 times. One cooperative launch per
// group: a grid of as many blocks as fit on the card at once loops over the
// (g, j, column tile) items; per hop each tile adds its rank's contribution
// to the f32 partial kept in a scratch row (G, s, d), folds its max|acc|
// into the row's slot with atomicMax on the float's bits (non-negative
// floats order as integers, so the max is exact and independent of order),
// and the grid synchronises (cooperative_groups grid.sync, no -rdc needed)
// before the next hop reads the slot. A block handles the same items at
// every hop, so each thread re-reads only what it wrote itself. The last
// hop divides and writes the n outputs. Extra traffic over the bound: the
// partial's round trip, 8 bytes per element per hop. Any d (16-byte
// payload loads when d and the alignment allow), any n >= 1, any s; the
// kernel allocates nothing (the wrapper passes the scratch row and the
// zeroed slots) and runs on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ring_common.cuh"

namespace repro_torch {
namespace {

namespace cg = cooperative_groups;

using ring::decode;
using ring::kThreads;
using ring::load_mask;
using ring::load_pack;
using ring::Pack;
using ring::store_pack;

// the int8 wire's step from a row's max|acc| (held as its bits)
__device__ __forceinline__ float row_delta(unsigned int amax_bits,
                                           float levels) {
  const float amax = __uint_as_float(amax_bits);
  return __fdiv_rn(amax > 0.0f ? amax : 1.0f, levels);
}

// rint(a / D) clipped to +-levels, through int as the int8 cast goes (so a
// negative zero decodes as +0), times D
__device__ __forceinline__ float requant(float a, float delta, float levels) {
  float q = rintf(__fdiv_rn(a, delta));
  q = fminf(fmaxf(q, -levels), levels);
  return __fmul_rn(static_cast<float>(static_cast<int>(q)), delta);
}

// levels > 0: one cooperative launch; the f32 partial lives in `part`
// (G, s, d) between hops and each row's max|acc| after hop t in
// amax[row * n + t] (zeroed by the caller).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ring_requant_kernel(const T* __restrict__ stack,
                        const int8_t* __restrict__ enc,
                        const float* __restrict__ scale, const void* rs,
                        DType rs_dtype, const void* ag, DType ag_dtype,
                        const float* __restrict__ div, T* __restrict__ out,
                        float* part, unsigned int* amax, int n, int64_t s,
                        int64_t d, int64_t rows, int64_t tiles, float levels,
                        bool renorm) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float s_max[kThreads / 32];
  const int64_t items = rows * tiles;
  const int64_t stride = s * d;  // from rank r to rank r + 1
  for (int t = 0; t < n; ++t) {  // hop t + 1 adds rank owner + 1 + t
    const bool last = t == n - 1;
    for (int64_t w = blockIdx.x; w < items; w += gridDim.x) {
      const int64_t row = w / tiles;  // g * s + j
      const int64_t tile = w % tiles;
      const int64_t g = row / s;
      const int64_t j = row % s;
      const int64_t col = (tile * kThreads + threadIdx.x) * VEC;
      float local = 0.0f;
      if (col < d) {
        const int owner = static_cast<int>(j % n);
        int r = owner + 1 + t;
        if (r >= n) r -= n;
        const int64_t mi = (g * n + r) * s + j;
        const float m = load_mask(rs, rs_dtype, mi);
        const float sc = scale[mi];
        const Pack<int8_t, VEC> q =
            load_pack<true, int8_t, VEC>(enc + mi * d + col);
        float* mine_part = part + row * d + col;
        float acc[VEC];
        if (t == 0) {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = __fmul_rn(decode<T>(q.v[v], sc), m);
        } else {
          const float delta =
              row_delta(__ldcg(amax + row * n + t - 1), levels);
          const Pack<float, VEC> prev =
              load_pack<false, float, VEC>(mine_part);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[v] = __fadd_rn(requant(prev.v[v], delta, levels),
                               __fmul_rn(decode<T>(q.v[v], sc), m));
        }
        if (!last) {
          Pack<float, VEC> keep;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            keep.v[v] = acc[v];
            local = fmaxf(local, fabsf(acc[v]));
          }
          store_pack<float, VEC>(mine_part, keep);
        } else {
          const float dv = div[row];
          Pack<T, VEC> mine, zero;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            mine.v[v] = from_float<T>(__fdiv_rn(acc[v], dv));
            zero.v[v] = from_float<T>(0.0f);
          }
          const int64_t base = (g * n * s + j) * d + col;
          for (int i = 0; i < n; ++i) {
            T* dst = out + base + i * stride;
            if (load_mask(ag, ag_dtype, (g * n + i) * s + j) != 0.0f) {
              store_pack<T, VEC>(dst, mine);
            } else if (renorm) {
              store_pack<T, VEC>(
                  dst, load_pack<true, T, VEC>(stack + base + i * stride));
            } else {
              store_pack<T, VEC>(dst, zero);
            }
          }
        }
      }
      if (!last) {  // the tile's max|acc| into the row's slot
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          local = fmaxf(local, __shfl_xor_sync(0xffffffffu, local, off));
        if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = local;
        __syncthreads();
        if (threadIdx.x == 0) {
          float b = s_max[0];
          for (int i = 1; i < kThreads / 32; ++i) b = fmaxf(b, s_max[i]);
          atomicMax(amax + row * n + t, __float_as_uint(b));
        }
        __syncthreads();
      }
    }
    if (!last) grid.sync();
  }
}

template <typename T, int VEC>
cudaError_t launch_requant(const T* stack, const int8_t* enc,
                           const float* scale, const void* rs, DType rs_dtype,
                           const void* ag, DType ag_dtype, const float* div,
                           T* out, float* part, unsigned int* amax, int64_t G,
                           int64_t n, int64_t s, int64_t d, int levels,
                           bool renorm, cudaStream_t stream) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  auto* kernel = &ring_requant_kernel<T, VEC>;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int64_t tiles = (d + kThreads * VEC - 1) / (kThreads * VEC);
  int64_t rows = G * s;
  const int64_t items = rows * tiles;
  const int64_t most = static_cast<int64_t>(per_sm) * sms;
  const dim3 grid(static_cast<unsigned>(items < most ? items : most));
  int n_arg = static_cast<int>(n);
  float levels_arg = static_cast<float>(levels);
  void* args[] = {&stack, &enc,   &scale, &rs,         &rs_dtype,
                  &ag,    &ag_dtype, &div, &out,       &part,
                  &amax,  &n_arg, &s,     &d,          &rows,
                  &tiles, &levels_arg, &renorm};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     grid, dim3(kThreads), args, 0, stream);
}

template <typename T>
cudaError_t launch_typed(const void* stack, const void* enc,
                         const float* scale, const void* rs, DType rs_dtype,
                         const void* ag, DType ag_dtype, const float* div,
                         void* out, float* part, unsigned int* amax,
                         int levels, bool renorm, int64_t G, int64_t n,
                         int64_t s, int64_t d, cudaStream_t stream) {
  constexpr int kVec = static_cast<int>(sizeof(uint4) / sizeof(T));
  const T* x = static_cast<const T*>(stack);
  const int8_t* q = static_cast<const int8_t*>(enc);
  T* y = static_cast<T*>(out);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % sizeof(uint4) == 0;
  };
  if (d % kVec == 0 && aligned(x) && aligned(y) && aligned(q) &&
      aligned(part)) {
    return launch_requant<T, kVec>(x, q, scale, rs, rs_dtype, ag, ag_dtype,
                                   div, y, part, amax, G, n, s, d, levels,
                                   renorm, stream);
  }
  return launch_requant<T, 1>(x, q, scale, rs, rs_dtype, ag, ag_dtype, div,
                              y, part, amax, G, n, s, d, levels, renorm,
                              stream);
}

}  // namespace

cudaError_t ring_requant_launch(const void* stack, DType dtype,
                                const void* enc, const float* scale,
                                const void* rs, DType rs_dtype,
                                const void* ag, DType ag_dtype,
                                const float* div, void* out, float* part,
                                unsigned int* amax, int levels, bool renorm,
                                int64_t G, int64_t n, int64_t s, int64_t d,
                                cudaStream_t stream) {
  switch (dtype) {
    case DType::kF32:
      return launch_typed<float>(stack, enc, scale, rs, rs_dtype, ag,
                                 ag_dtype, div, out, part, amax, levels,
                                 renorm, G, n, s, d, stream);
    case DType::kBF16:
      return launch_typed<__nv_bfloat16>(stack, enc, scale, rs, rs_dtype, ag,
                                         ag_dtype, div, out, part, amax,
                                         levels, renorm, G, n, s, d, stream);
    default:
      return cudaErrorInvalidValue;  // the binding admits only f32 and bf16
  }
}

}  // namespace repro_torch
