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
// at an H100 SXM's 3.35 TB/s (data sheet, 700 W); on the int8 wire the
// re-encoding hop moves 21.2 MB there (two int8 rows in, one out), 6.3 us.
//
// What the design does about it:
//   - the linear hops and the landings (the first, simple form): one thread
//     block of 256 threads per row on grid.y and column tiles on grid.x,
//     each thread walking its columns with a grid stride, neighbouring
//     threads on neighbouring columns so a warp's loads coalesce; the
//     row's mask, scale and divisor are read once per block;
//   - the re-encoding hops (levels > 0; redesigned): the encode needs
//     max|acc| over the whole row before any column of it can be encoded,
//     and on the collective path a chunk is one row (k = 1) of up to
//     7,077,888 columns, so a row is split over the whole card. The wrapper
//     (kernels/ring.py::rank_requant_plan) gives each row `blocks` blocks
//     of `cols` columns (a multiple of 16), enough that the grid holds two
//     blocks per SM; a block keeps at least 4,096 columns. With one block a
//     row (k alone fills the card, or the row is narrow) the hop is one
//     launch: the block finds the row's max, then encodes. With more it is
//     two launches: pass 1 writes each block's max|acc| to the (k, blocks)
//     scratch `part_max` (no atomics, nothing to zero); pass 2, a
//     programmatic dependent launch whose blocks are scheduled while pass
//     1 drains, reduces the row's maxima, forms D, recomputes acc from the
//     inputs -- at the largest chunk 14.2 MB, which the 50 MB L2 still
//     holds -- and encodes; block 0 of a row writes its D. A max over the
//     bits of non-negative floats is exact and independent of order, so
//     the split changes no bit. One cooperative launch that kept each
//     block's columns in shared memory across a grid barrier (brought in
//     by the copy engine) was tried on an H100 and was no faster: the two
//     launches stay;
//   - 16 int8 columns (16 bytes) of the chunk and of the received partial
//     a thread at a time, two such pairs of loads in flight, 16 encoded
//     bytes stored at once, when W is a multiple of 16 and the three row
//     bases are 16-byte aligned; other shapes take the same passes a
//     column a thread;
//   - no conversion instruction (a quarter of the f32 add's rate) on the
//     16-column path: an int8 value becomes a float by a byte permute and
//     an add (an exact bias trick), and the encode takes one reciprocal a
//     row, then two fused multiply-adds, a clip and a rounding add an
//     element
//     (ring_common.cuh::encode_fma, shared with ring_q.cu) where that is
//     exact (a finite row max, D in [2^-100, 2^100]) and divides
//     elsewhere, so non-finite rows keep their bits.
// Overlapping hop t's transfer with hop t - 1's add (the TPU kernel's
// double buffer) is left to a later redesign. Any W >= 1, any k >= 1; the
// kernels allocate nothing (the wrapper passes the scratch) and run on the
// caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ring_common.cuh"

namespace repro_torch {
namespace {

using ring::abs_max;
using ring::delta_of;
using ring::encode;
using ring::encode_fma;
using ring::fma_encodes;
using ring::load_mask;
using ring::load_pack;
using ring::Pack;
using ring::round_acc;
using ring::store_pack;

constexpr int kHopThreads = 256;
// the re-encoding hop: threads a block, and vectors a thread keeps in flight
constexpr int kRowThreads = 256;
constexpr int kRowUnroll = 2;
// its passes: one block a row does both; split rows take two launches
constexpr int kFused = 0;
constexpr int kMaxPass = 1;
constexpr int kEncodePass = 2;
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

// the block's max of the threads' `local` maxima, in every thread
__device__ __forceinline__ float block_abs_max(float local, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local = abs_max(local, __shfl_xor_sync(0xffffffffu, local, off));
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = local;
  __syncthreads();
  float b = s_warp[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w) b = abs_max(b, s_warp[w]);
  return b;
}

// float(q) of VEC int8 values; four at a time without a conversion
// instruction: the byte q + 128 placed in the low mantissa bits of 2^23
// gives 2^23 + q + 128 exactly, less 2^23 + 128 gives q
template <int VEC>
__device__ __forceinline__ void int8_floats(const Pack<int8_t, VEC>& q,
                                            float (&f)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC / 4; ++j) {
      uint32_t w;
      memcpy(&w, &q.v[4 * j], 4);
      w ^= 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f[4 * j + i] = __fadd_rn(
            __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | i)),
            -8388736.0f);
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = static_cast<float>(q.v[e]);
  }
}

// body(acc, v) for each of the block's `nvec` vectors of VEC columns of s
// and rv: acc = float(q) * sc * m (+ float(q_recv) * rsc), every op
// rounded to nearest; the loads of kRowUnroll vectors are issued before
// any is used
template <int VEC, bool HAS_RECV, typename F>
__device__ __forceinline__ void for_acc(const int8_t* __restrict__ s,
                                        const int8_t* __restrict__ rv,
                                        int64_t nvec, float sc, float m,
                                        float rsc, F body) {
  for (int64_t v0 = threadIdx.x; v0 < nvec;
       v0 += static_cast<int64_t>(kRowUnroll) * kRowThreads) {
    Pack<int8_t, VEC> q[kRowUnroll], rq[kRowUnroll];
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int64_t v = v0 + u * kRowThreads;
      if (v < nvec) {
        q[u] = load_pack<true, int8_t, VEC>(s + v * VEC);
        if constexpr (HAS_RECV)
          rq[u] = load_pack<true, int8_t, VEC>(rv + v * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowUnroll; ++u) {
      const int64_t v = v0 + u * kRowThreads;
      if (v < nvec) {
        float acc[VEC], fr[VEC];
        int8_floats<VEC>(q[u], acc);
        if constexpr (HAS_RECV) int8_floats<VEC>(rq[u], fr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float c = __fmul_rn(__fmul_rn(acc[e], sc), m);
          acc[e] = HAS_RECV ? __fadd_rn(__fmul_rn(fr[e], rsc), c) : c;
        }
        body(acc, v);
      }
    }
  }
}

// One block's share of a chunk row: row r of the chunk, its mask and
// scales, and its columns [blockIdx.x * cols, + cols) of the chunk and of
// the received partial (`nvec` vectors of VEC columns)
struct Tile {
  int64_t r, col0, nvec;
  float m, sc, rsc;
  const int8_t* s;
  const int8_t* rv;
};

template <int VEC, bool HAS_RECV>
__device__ __forceinline__ Tile tile_of(const int8_t* src,
                                        const float* src_scale,
                                        const void* rs, DType rs_dtype,
                                        const int8_t* recv,
                                        const float* recv_scale,
                                        int64_t chunk, int64_t W,
                                        int64_t cols) {
  Tile t;
  t.r = blockIdx.y;
  const int64_t row = chunk * gridDim.y + t.r;
  t.col0 = blockIdx.x * cols;
  t.nvec = (W - t.col0 < cols ? W - t.col0 : cols) / VEC;
  t.m = load_mask(rs, rs_dtype, row);
  t.sc = src_scale[row];
  t.rsc = HAS_RECV ? recv_scale[t.r] : 1.0f;
  t.s = src + row * W + t.col0;
  t.rv = HAS_RECV ? recv + t.r * W + t.col0 : nullptr;
  return t;
}

// this thread's share of the tile's max|acc|
template <int VEC, bool HAS_RECV>
__device__ __forceinline__ float thread_max(const Tile& t) {
  float local = 0.0f;
  for_acc<VEC, HAS_RECV>(t.s, t.rv, t.nvec, t.sc, t.m, t.rsc,
                         [&](const float (&acc)[VEC], int64_t) {
#pragma unroll
                           for (int e = 0; e < VEC; ++e)
                             local = abs_max(local, fabsf(acc[e]));
                         });
  return local;
}

// the row's max|acc| from its blocks' maxima part_max[r, :], written by
// the grid before, in every thread
__device__ __forceinline__ float row_max(const float* part_max, int64_t r,
                                         float* s_warp) {
  const int64_t parts = gridDim.x;
  float local = 0.0f;
  for (int64_t b = threadIdx.x; b < parts; b += kRowThreads)
    local = abs_max(local, __ldcg(part_max + r * parts + b));
  return block_abs_max(local, s_warp);
}

// the tile's columns encoded at the row's step into o; the row's max and
// the step's range decide the encode once for the block, not per element
template <int VEC, bool HAS_RECV>
__device__ __forceinline__ void encode_tile(const Tile& t, float amax,
                                            float levels, int8_t* o) {
  const float delta = delta_of(amax, levels);
  const auto pass = [&](auto enc) {
    for_acc<VEC, HAS_RECV>(t.s, t.rv, t.nvec, t.sc, t.m, t.rsc,
                           [&](const float (&acc)[VEC], int64_t v) {
                             Pack<int8_t, VEC> q;
#pragma unroll
                             for (int e = 0; e < VEC; ++e)
                               q.v[e] = static_cast<int8_t>(enc(acc[e]));
                             store_pack<int8_t, VEC>(o + v * VEC, q);
                           });
  };
  if (fma_encodes(amax, delta)) {
    const float inv = __frcp_rn(delta);
    pass([&](float a) { return encode_fma(a, delta, inv, levels); });
  } else {
    pass([&](float a) { return encode(a, delta, levels); });
  }
}

// A re-encoding hop on the int8 wire (accumulation in f32). Block
// (blockIdx.x, r) owns a Tile of the chunk's row r. PASS kFused (one block
// a row): the row's max, then the encode. kMaxPass: the block's max|acc|
// into part_max[r, blockIdx.x]. kEncodePass (a programmatic dependent
// launch after kMaxPass): the row's max from part_max, then the encode of
// the block's columns, read again (from L2 at the path's chunks). Block 0
// of a row writes its step.
template <int VEC, bool HAS_RECV, int PASS>
__global__ void __launch_bounds__(kRowThreads)
    ring_rank_requant_kernel(const int8_t* __restrict__ src,
                             const float* __restrict__ src_scale,
                             const void* rs, DType rs_dtype,
                             const int8_t* __restrict__ recv,
                             const float* __restrict__ recv_scale,
                             int8_t* __restrict__ out,
                             float* __restrict__ out_scale,
                             float* __restrict__ part_max, int64_t chunk,
                             int64_t W, int64_t cols, float levels) {
  __shared__ float s_warp[kRowThreads / 32];
  const Tile t = tile_of<VEC, HAS_RECV>(src, src_scale, rs, rs_dtype, recv,
                                        recv_scale, chunk, W, cols);
  float amax;
  if constexpr (PASS == kEncodePass) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    amax = row_max(part_max, t.r, s_warp);
  } else {
    if constexpr (PASS == kMaxPass) {
      // pass 2 may be scheduled now; it waits for this grid's maxima
      asm volatile("griddepcontrol.launch_dependents;");
    }
    amax = block_abs_max(thread_max<VEC, HAS_RECV>(t), s_warp);
    if constexpr (PASS == kMaxPass) {
      if (threadIdx.x == 0) part_max[t.r * gridDim.x + blockIdx.x] = amax;
      return;
    }
  }
  encode_tile<VEC, HAS_RECV>(t, amax, levels, out + t.r * W + t.col0);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    out_scale[t.r] = delta_of(amax, levels);
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

template <int VEC, bool HAS_RECV>
cudaError_t requant_passes(const int8_t* src, const float* src_scale,
                           const void* rs, DType rs_dtype,
                           const int8_t* recv, const float* recv_scale,
                           int8_t* out, float* out_scale, float* part_max,
                           int64_t chunk, int64_t k, int64_t W,
                           int64_t blocks, int64_t cols, float levels,
                           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(k));
  if (blocks == 1) {
    ring_rank_requant_kernel<VEC, HAS_RECV, kFused>
        <<<grid, kRowThreads, 0, stream>>>(src, src_scale, rs, rs_dtype,
                                           recv, recv_scale, out, out_scale,
                                           part_max, chunk, W, cols, levels);
    return cudaGetLastError();
  }
  ring_rank_requant_kernel<VEC, HAS_RECV, kMaxPass>
      <<<grid, kRowThreads, 0, stream>>>(src, src_scale, rs, rs_dtype, recv,
                                         recv_scale, out, out_scale,
                                         part_max, chunk, W, cols, levels);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // pass 2 as a programmatic dependent launch: its blocks are scheduled
  // while pass 1 finishes and wait (griddepcontrol.wait) for its maxima
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kRowThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(
      &config, &ring_rank_requant_kernel<VEC, HAS_RECV, kEncodePass>, src,
      src_scale, rs, rs_dtype, recv, recv_scale, out, out_scale, part_max,
      chunk, W, cols, levels);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// 16 columns a thread where W is a multiple of 16 and the row bases are
// 16-byte aligned (blocks start at multiples of 16 columns), else one
template <bool HAS_RECV>
cudaError_t requant_hop(const int8_t* src, const float* src_scale,
                        const void* rs, DType rs_dtype, const int8_t* recv,
                        const float* recv_scale, int8_t* out,
                        float* out_scale, float* part_max, int64_t chunk,
                        int64_t k, int64_t W, int64_t blocks, int64_t cols,
                        int levels, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const float lv = static_cast<float>(levels);
  if (W % 16 == 0 && aligned(src) && aligned(out) &&
      (!HAS_RECV || aligned(recv)))
    return requant_passes<16, HAS_RECV>(src, src_scale, rs, rs_dtype, recv,
                                        recv_scale, out, out_scale, part_max,
                                        chunk, k, W, blocks, cols, lv,
                                        stream);
  return requant_passes<1, HAS_RECV>(src, src_scale, rs, rs_dtype, recv,
                                     recv_scale, out, out_scale, part_max,
                                     chunk, k, W, blocks, cols, lv, stream);
}

}  // namespace

cudaError_t ring_rank_hop_launch(const void* src, DType src_dtype,
                                 const float* src_scale, const void* rs,
                                 DType rs_dtype, const void* recv,
                                 DType recv_dtype, const float* recv_scale,
                                 const float* div, void* out, DType out_dtype,
                                 float* out_scale, float* part_max,
                                 DType acc_dtype, int levels, bool last,
                                 int64_t chunk, int64_t k, int64_t W,
                                 int64_t blocks, int64_t cols,
                                 cudaStream_t stream) {
  if (levels > 0 && !last) {  // the binding admits only int8 here
    const int8_t* q = static_cast<const int8_t*>(src);
    const int8_t* rq = static_cast<const int8_t*>(recv);
    int8_t* o = static_cast<int8_t*>(out);
    if (rq != nullptr)
      return requant_hop<true>(q, src_scale, rs, rs_dtype, rq, recv_scale, o,
                               out_scale, part_max, chunk, k, W, blocks,
                               cols, levels, stream);
    return requant_hop<false>(q, src_scale, rs, rs_dtype, rq, recv_scale, o,
                              out_scale, part_max, chunk, k, W, blocks, cols,
                              levels, stream);
  }
  switch (src_dtype) {
    case DType::kI8:  // the binding sums int8 in f32
      hop_acc<int8_t>(DType::kF32, recv_dtype, out_dtype, src, src_scale, rs,
                      rs_dtype, recv, recv_scale, div, out, chunk, k, W, last,
                      stream);
      break;
    case DType::kBF16:
      hop_acc<__nv_bfloat16>(acc_dtype, recv_dtype, out_dtype, src,
                             src_scale, rs, rs_dtype, recv, recv_scale, div,
                             out, chunk, k, W, last, stream);
      break;
    default:  // the binding admits only f32, bf16 and int8
      hop_acc<float>(acc_dtype, recv_dtype, out_dtype, src, src_scale, rs,
                     rs_dtype, recv, recv_scale, div, out, chunk, k, W, last,
                     stream);
  }
  return cudaGetLastError();
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
