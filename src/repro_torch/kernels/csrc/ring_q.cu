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
// contracted; rintf rounds half to even as torch.round does; the encode
// goes through int as the int8 cast does, so a negative zero decodes as
// +0; the row max is exact and independent of order; D = 1 / levels for an
// all-zero row. Non-finite partials go as in torch: a NaN in the row makes
// its max NaN and D = 1 / levels, an inf makes D inf, and a NaN quotient
// encodes as 0.
//
// What bounds it: bytes. The least traffic is the int8 table and its
// scales read once, the n outputs written once and the fallback blocks
// read where ag dropped them. At rps-100m's largest group (3, 16, 16,
// 1769472) f32 that is 8.48 GB, 2.53 ms at an H100 SXM's 3.35 TB/s (data
// sheet, 700 W), with the Bernoulli(0.7) masks of chip_smoke.py phase 19;
// at the training's p = 0.1 masks about 7.3 GB, 2.2 ms. The n outputs are
// about two thirds of it.
//
// What the design does about it. The re-encode needs max|acc| over a whole
// row (up to 1.77 M columns) before any column of it can be encoded, n - 1
// times; the max spans one row (g, j) only, so the row is the unit of
// synchronisation:
//   - the cluster path (cluster >= 1): one thread block cluster of up to 16
//     blocks per row, each block owning `chunk` columns. After the re-encode
//     the partial is q * D with |q| <= levels <= 127 and one f32 D per row
//     and hop, so the carry between hops is the int8 q, held in the block's
//     shared memory for all n hops (up to 192 KiB; at the largest group 16
//     blocks of 108 KiB, two per SM). A hop reads its rank's int8 table
//     once to find the block's max|acc|, the cluster combines the blocks'
//     maxima through distributed shared memory after one cluster barrier,
//     and a second pass recomputes acc = q * D + c from the carry and the
//     table (now in L2) and encodes the new carry. The f32 partial never
//     touches device memory; there is no grid-wide barrier and no atomic;
//     rows run independently;
//   - the table is read 16 columns (16 bytes) a thread at a time when d is
//     a multiple of 16 and the pointers are aligned (4 or 1 otherwise),
//     four loads unrolled in flight; the last hop divides and writes the
//     n outputs as 16-byte stores of neighbouring columns (4 f32 or 8
//     bf16 a thread), and copies the dropped blocks' fallback in loops of
//     their own, so those loads do not wait one by one;
//   - the encode needs rint(acc / D) for every element and hop: with
//     inv = rn(1 / D) once per hop, two fused multiply-adds give the
//     correctly rounded quotient (encode_fma) in place of a division;
//   - the wrapper (kernels/ring.py::requant_plan) picks the cluster size by
//     shape: the fewest blocks whose chunk fits two blocks per SM, doubled
//     while the card has fewer than two blocks per SM and a block keeps at
//     least 8192 columns;
//   - the wide path (cluster == 0), for a row wider than 16 blocks of
//     192 KiB hold (3,145,728 columns): the first design, one cooperative
//     launch whose f32 partial makes a round trip through a scratch row
//     every hop, with a grid barrier and a per-tile atomicMax on the row's
//     max after each hop.
// Any d, any n >= 1, any s; the kernel allocates nothing (the wrapper
// passes the wide path's scratch) and runs on the caller's stream.

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

// the cluster path's block: two blocks of 256 threads per SM
constexpr int kClusterThreads = 256;
// payload columns of one 16-byte store
template <typename T>
constexpr int kOutVec = static_cast<int>(sizeof(uint4) / sizeof(T));

// the larger of two non-negative floats (|acc| values and their maxima),
// NaN winning as torch.amax lets it: on their bits a sign-cleared NaN lies
// above +inf, and fmaxf would drop it
__device__ __forceinline__ float abs_max(float a, float b) {
  return __uint_as_float(max(__float_as_uint(a), __float_as_uint(b)));
}

// q clipped to +-levels, a NaN (from a non-finite partial or step) to 0 as
// the int8 cast of torch.clamp's NaN goes; fminf / fmaxf alone would give
// -levels
__device__ __forceinline__ float clip_q(float q, float levels) {
  return q != q ? 0.0f : fminf(fmaxf(q, -levels), levels);
}

// the int8 wire's step from a row's max|acc| (a NaN max gives 1 / levels,
// as torch.where(amax > 0, amax, 1) does)
__device__ __forceinline__ float delta_of(float amax, float levels) {
  return __fdiv_rn(amax > 0.0f ? amax : 1.0f, levels);
}

// the int8 wire's step from a row's max|acc| (held as its bits)
__device__ __forceinline__ float row_delta(unsigned int amax_bits,
                                           float levels) {
  return delta_of(__uint_as_float(amax_bits), levels);
}

// rint(a / D) clipped to +-levels, through int as the int8 cast goes (so a
// negative zero decodes as +0)
__device__ __forceinline__ int encode(float a, float delta, float levels) {
  return static_cast<int>(clip_q(rintf(__fdiv_rn(a, delta)), levels));
}

// The same encode at one row's step D, with its reciprocal inv = rn(1 / D)
// computed once: q0 = rn(a * inv), r = rn(a - q0 * D) and
// q1 = rn(q0 + r * inv) (two fused multiply-adds) is the correctly rounded
// quotient rn(a / D) -- the correction step of an FMA division, checked
// against exact rational arithmetic near the grid's half-integers
// (tests/test_torch_ring_int8.py) and by the kernel's bitwise sweeps
// against the plain version -- for a step D in [2^-100, 2^100], where the
// residual cannot leave the normal range for any |a / D| >= 1/4 (smaller
// quotients round to 0 either way), and for a finite row, where every
// |a| <= max|a| bounds |a / D| by about levels. The caller divides
// outside that range and in a row whose max is not finite (a NaN there
// makes D 1 / levels whatever the rest holds, so an inf or a huge a would
// turn the residual to NaN).
__device__ __forceinline__ int encode_fma(float a, float delta, float inv,
                                         float levels) {
  const float q0 = __fmul_rn(a, inv);
  const float r = __fmaf_rn(-q0, delta, a);
  const float q = fminf(fmaxf(rintf(__fmaf_rn(r, inv, q0)), -levels), levels);
  return static_cast<int>(q);
}

// encode and decode: the value the wire carries between two adds
__device__ __forceinline__ float requant(float a, float delta, float levels) {
  return __fmul_rn(static_cast<float>(encode(a, delta, levels)), delta);
}

// acc of the VEC columns at vector v of the block from their int8 table
// entries q: this hop's contribution, plus (after the first hop) the
// carried partial, int8 c times the previous hop's D
template <typename T, int VEC, bool FIRST>
__device__ __forceinline__ void hop_acc(const Pack<int8_t, VEC>& q,
                                        const int8_t* carry, float sc,
                                        float m, float delta, int64_t v,
                                        float (&acc)[VEC]) {
  if constexpr (FIRST) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = __fmul_rn(decode<T>(q.v[e], sc), m);
  } else {
    const Pack<int8_t, VEC> c = load_pack<false, int8_t, VEC>(carry + v * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] = __fadd_rn(__fmul_rn(static_cast<float>(c.v[e]), delta),
                         __fmul_rn(decode<T>(q.v[e], sc), m));
  }
}

// A pass over the block's vectors, each with its int8 table entries; four
// iterations unrolled, so four 16-byte loads a thread in flight.
template <int VEC, typename F>
__device__ __forceinline__ void for_vectors(const int8_t* __restrict__ src,
                                            int64_t nvec, F body) {
#pragma unroll 4
  for (int64_t v = threadIdx.x; v < nvec; v += kClusterThreads)
    body(load_pack<true, int8_t, VEC>(src + v * VEC), v);
}

// pass 1 of a hop: the block's share of max|acc|, per thread
template <typename T, int VEC, bool FIRST>
__device__ __forceinline__ float hop_max(const int8_t* __restrict__ src,
                                         const int8_t* carry, float sc,
                                         float m, float delta, int64_t nvec) {
  float local = 0.0f;
  for_vectors<VEC>(src, nvec, [&](const Pack<int8_t, VEC>& q, int64_t v) {
    float acc[VEC];
    hop_acc<T, VEC, FIRST>(q, carry, sc, m, delta, v, acc);
#pragma unroll
    for (int e = 0; e < VEC; ++e) local = abs_max(local, fabsf(acc[e]));
  });
  return local;
}

// pass 2 of a hop: acc again (the table now from L2), encoded at the row's
// new grid into the carry; each thread rewrites only the carry it reads
template <typename T, int VEC, bool FIRST>
__device__ __forceinline__ void hop_encode(const int8_t* __restrict__ src,
                                           int8_t* carry, float sc, float m,
                                           float delta, int64_t nvec,
                                           float next, float levels,
                                           float amax) {
  // the row's max and the step's range decide the encode once for the
  // whole pass, not per element
  const auto pass = [&](auto enc) {
    for_vectors<VEC>(src, nvec, [&](const Pack<int8_t, VEC>& q, int64_t v) {
      float acc[VEC];
      hop_acc<T, VEC, FIRST>(q, carry, sc, m, delta, v, acc);
      Pack<int8_t, VEC> c;
#pragma unroll
      for (int e = 0; e < VEC; ++e) c.v[e] = static_cast<int8_t>(enc(acc[e]));
      store_pack<int8_t, VEC>(carry + v * VEC, c);
    });
  };
  if (amax <= 0x1.fffffep127f && next >= 0x1p-100f && next <= 0x1p100f) {
    const float inv = __frcp_rn(next);
    pass([&](float a) { return encode_fma(a, next, inv, levels); });
  } else {
    pass([&](float a) { return encode(a, next, levels); });
  }
}

// the last hop: acc / div into every rank whose all-gather arrived, and
// zero (grad) or the rank's own block (renorm) elsewhere. The stores of one
// vector depend on nothing but acc; the fallback copies go in a loop of
// their own, so their loads are many in flight and not one per store.
template <typename T, int VEC, bool FIRST>
__device__ __forceinline__ void hop_out(
    const int8_t* __restrict__ src, const int8_t* carry, float sc, float m,
    float delta, int64_t nvec, const T* __restrict__ stack,
    T* __restrict__ out, const void* ag, DType ag_dtype, int n, int64_t g,
    int64_t s, int64_t j, int64_t base, int64_t stride, float dv,
    bool renorm) {
  const auto arrived = [&](int i) {
    return load_mask(ag, ag_dtype, (g * n + i) * s + j) != 0.0f;
  };
  uint32_t keep = 0;  // the all-gather masks of ranks 0..31
  for (int i = 0; i < n && i < 32; ++i)
    if (arrived(i)) keep |= 1u << i;
#pragma unroll 2
  for (int64_t v = threadIdx.x; v < nvec; v += kClusterThreads) {
    float acc[VEC];
    hop_acc<T, VEC, FIRST>(load_pack<true, int8_t, VEC>(src + v * VEC), carry,
                           sc, m, delta, v, acc);
    Pack<T, VEC> mine, zero;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mine.v[e] = from_float<T>(__fdiv_rn(acc[e], dv));
      zero.v[e] = from_float<T>(0.0f);
    }
    const int64_t at = base + v * VEC;
    for (int i = 0; i < n; ++i) {
      const bool on = i < 32 ? ((keep >> i) & 1u) != 0 : arrived(i);
      if (on) {
        store_pack<T, VEC>(out + at + i * stride, mine);
      } else if (!renorm) {
        store_pack<T, VEC>(out + at + i * stride, zero);
      }
    }
  }
  if (!renorm) return;
  for (int i = 0; i < n; ++i) {
    if (i < 32 ? ((keep >> i) & 1u) != 0 : arrived(i)) continue;
    const T* from = stack + base + i * stride;
    T* to = out + base + i * stride;
#pragma unroll 4
    for (int64_t v = threadIdx.x; v < nvec; v += kClusterThreads)
      store_pack<T, VEC>(to + v * VEC, load_pack<true, T, VEC>(from + v * VEC));
  }
}

// the cluster path. Row (g, j) = blockIdx.x / cluster; the block of rank
// `part` in its cluster owns columns [part * chunk, part * chunk + chunk)
// and keeps their int8 carry in dynamic shared memory. `chunk` is a
// multiple of 16 (so of VEC); d is a multiple of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kClusterThreads, 2)
    ring_requant_cluster_kernel(const T* __restrict__ stack,
                                const int8_t* __restrict__ enc,
                                const float* __restrict__ scale,
                                const void* rs, DType rs_dtype,
                                const void* ag, DType ag_dtype,
                                const float* __restrict__ div,
                                T* __restrict__ out, int n, int64_t s,
                                int64_t d, int64_t chunk, float levels,
                                bool renorm) {
  extern __shared__ __align__(16) int8_t s_carry[];
  __shared__ float s_warp[kClusterThreads / 32];
  __shared__ float s_block[2];  // this block's max|acc|, by hop parity
  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = static_cast<int>(cluster.num_blocks());
  const int part = static_cast<int>(cluster.block_rank());
  const int64_t row = blockIdx.x / blocks;  // g * s + j
  const int64_t g = row / s;
  const int64_t j = row % s;
  const int64_t col0 = part * chunk;
  const int64_t cols = col0 < d ? (d - col0 < chunk ? d - col0 : chunk) : 0;
  const int64_t nvec = cols / VEC;
  const int owner = static_cast<int>(j % n);
  float delta = 0.0f;            // D of the previous hop
  for (int t = 0; t < n; ++t) {  // hop t + 1 adds rank owner + 1 + t
    int r = owner + 1 + t;
    if (r >= n) r -= n;
    const int64_t mi = (g * n + r) * s + j;
    const float m = load_mask(rs, rs_dtype, mi);
    const float sc = scale[mi];
    const int8_t* src = enc + mi * d + col0;
    if (t == n - 1) {
      // the outputs in 16-byte stores of neighbouring columns: OV columns
      // a thread (VEC's 16 f32 columns would put 64 bytes between lanes);
      // the carry written by other threads at the last encode is read
      constexpr int OV = VEC < kOutVec<T> ? VEC : kOutVec<T>;
      const int64_t base = (g * n * s + j) * d + col0;
      const float dv = div[row];
      __syncthreads();
      if (t == 0) {
        hop_out<T, OV, true>(src, s_carry, sc, m, delta, cols / OV, stack,
                             out, ag, ag_dtype, n, g, s, j, base, s * d, dv,
                             renorm);
      } else {
        hop_out<T, OV, false>(src, s_carry, sc, m, delta, cols / OV, stack,
                              out, ag, ag_dtype, n, g, s, j, base, s * d, dv,
                              renorm);
      }
      break;
    }
    float local = t == 0
        ? hop_max<T, VEC, true>(src, s_carry, sc, m, delta, nvec)
        : hop_max<T, VEC, false>(src, s_carry, sc, m, delta, nvec);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      local = abs_max(local, __shfl_xor_sync(0xffffffffu, local, off));
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = local;
    __syncthreads();
    if (threadIdx.x == 0) {
      float b = s_warp[0];
      for (int i = 1; i < kClusterThreads / 32; ++i) {
        b = abs_max(b, s_warp[i]);
      }
      s_block[t & 1] = b;
    }
    // every block's max is written (and s_warp read) before any block
    // reads the maxima or writes s_warp again; s_block alternates, so a
    // block one hop ahead never overwrites a slot that is still read
    cluster.sync();
    float amax = 0.0f;
#pragma unroll
    for (int b = 0; b < static_cast<int>(kRingQMaxCluster); ++b) {
      if (b < blocks)
        amax = abs_max(amax, *cluster.map_shared_rank(&s_block[t & 1], b));
    }
    const float next = delta_of(amax, levels);
    if (t == 0) {
      hop_encode<T, VEC, true>(src, s_carry, sc, m, delta, nvec, next,
                               levels, amax);
    } else {
      hop_encode<T, VEC, false>(src, s_carry, sc, m, delta, nvec, next,
                                levels, amax);
    }
    delta = next;
  }
  // no block leaves while another may still read its s_block
  if (n > 1) cluster.sync();
}

template <typename T, int VEC>
cudaError_t launch_cluster(const T* stack, const int8_t* enc,
                           const float* scale, const void* rs, DType rs_dtype,
                           const void* ag, DType ag_dtype, const float* div,
                           T* out, int64_t G, int64_t n, int64_t s, int64_t d,
                           int cluster, int64_t chunk, int levels,
                           bool renorm, cudaStream_t stream) {
  auto* kernel = &ring_requant_cluster_kernel<T, VEC>;
  const size_t smem = static_cast<size_t>(chunk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(G * s * cluster));
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &config);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  return cudaLaunchKernelEx(&config, kernel, stack, enc, scale, rs, rs_dtype,
                            ag, ag_dtype, div, out, static_cast<int>(n), s, d,
                            chunk, static_cast<float>(levels), renorm);
}

// The wide path (cluster == 0: a row wider than the largest cluster holds):
// one cooperative launch; the f32 partial lives in `part` (G, s, d) between
// hops and each row's max|acc| after hop t in amax[row * n + t] (zeroed by
// the caller).
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
            local = abs_max(local, fabsf(acc[v]));
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
          local = abs_max(local, __shfl_xor_sync(0xffffffffu, local, off));
        if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = local;
        __syncthreads();
        if (threadIdx.x == 0) {
          float b = s_max[0];
          for (int i = 1; i < kThreads / 32; ++i) b = abs_max(b, s_max[i]);
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
                         int64_t s, int64_t d, int cluster, int64_t chunk,
                         cudaStream_t stream) {
  constexpr int kVec = static_cast<int>(sizeof(uint4) / sizeof(T));
  const T* x = static_cast<const T*>(stack);
  const int8_t* q = static_cast<const int8_t*>(enc);
  T* y = static_cast<T*>(out);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % sizeof(uint4) == 0;
  };
  const bool al = aligned(x) && aligned(y) && aligned(q);
  if (cluster > 0) {
    // 16 int8 columns per load, or 4 (one word of the table, 16 bytes of
    // an f32 output), or 1
    if (d % 16 == 0 && al) {
      return launch_cluster<T, 16>(x, q, scale, rs, rs_dtype, ag, ag_dtype,
                                   div, y, G, n, s, d, cluster, chunk, levels,
                                   renorm, stream);
    }
    if (d % 4 == 0 && al) {
      return launch_cluster<T, 4>(x, q, scale, rs, rs_dtype, ag, ag_dtype,
                                  div, y, G, n, s, d, cluster, chunk, levels,
                                  renorm, stream);
    }
    return launch_cluster<T, 1>(x, q, scale, rs, rs_dtype, ag, ag_dtype, div,
                                y, G, n, s, d, cluster, chunk, levels, renorm,
                                stream);
  }
  if (d % kVec == 0 && al && aligned(part)) {
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
                                int cluster, int64_t chunk,
                                cudaStream_t stream) {
  switch (dtype) {
    case DType::kF32:
      return launch_typed<float>(stack, enc, scale, rs, rs_dtype, ag,
                                 ag_dtype, div, out, part, amax, levels,
                                 renorm, G, n, s, d, cluster, chunk, stream);
    case DType::kBF16:
      return launch_typed<__nv_bfloat16>(stack, enc, scale, rs, rs_dtype, ag,
                                         ag_dtype, div, out, part, amax,
                                         levels, renorm, G, n, s, d, cluster,
                                         chunk, stream);
    default:
      return cudaErrorInvalidValue;  // the binding admits only f32 and bf16
  }
}

}  // namespace repro_torch
