// Plain C++ interface of the port's CUDA kernels, shared by the CUDA
// sources and their PyTorch binding (binding.cpp). No PyTorch header is
// included here, so nvcc compiles the .cu files without them.
#pragma once

#include <cstdint>

#include <cuda_runtime_api.h>

namespace repro_torch {

// Element types the kernels read. masked_avg blocks, rwkv6 inputs and
// rglru x: kF32, kBF16, kF16. rglru a: kF32 or x's type. ring_round
// payload and accumulation: kF32, kBF16; its encoded table: kI8 or the
// payload type. tp_combine partials and wire: kF32, kBF16; its masks:
// bool. masked_avg and ring_round masks: any.
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

// Enqueues the tensor-parallel combine of one drop-masked decode site
// (masked_avg.cu): for the partials (n, B, 1, d) of type partials_dtype (kF32
// or kBF16) at element strides sn, sb, sc (worker, request, column), the
// site's (n, s) bool rs rows at rs_site (element strides rs_sn, rs_ss:
// worker, block) and the receiver's (s) bool ag row at ag_row (stride
// ag_ss), writes the receiver's consensus (B, 1, d) in f32 to the contiguous
// `out`: the plan's server block j = (c * B + b) / blk of each element,
// renormalised over rs in the wire type wire_dtype (kF32 or kBF16) where ag
// keeps it, else the receiver's own n * p. Needs 0 <= receiver < n,
// B <= 65535 (grid.y) and B * d < 2^31. Does not synchronise; the caller
// checks cudaGetLastError() right after.
void tp_combine_launch(const void* partials, DType partials_dtype, int64_t sn,
                       int64_t sb, int64_t sc, const bool* rs_site,
                       int64_t rs_sn, int64_t rs_ss, const bool* ag_row,
                       int64_t ag_ss, DType wire_dtype, float* out, int64_t n,
                       int64_t B, int64_t d, int64_t blk, int64_t receiver,
                       cudaStream_t stream);

// The largest dk and dv the RWKV-6 kernel takes (both are padded to it).
constexpr int64_t kRwkv6MaxDim = 64;

// Floats of scratch the RWKV-6 launch needs: per (b, h) and chunk of 64
// tokens, the (64, 64) state it passes on.
int64_t rwkv6_scratch_floats(int64_t B, int64_t S, int64_t H);

// Enqueues the RWKV-6 recurrence from a zero state over contiguous
// r, k, w (B, S, H, dk) and v (B, S, H, dv), all of type `dtype`, with the
// f32 bonus u (H, dk): writes out (B, S, H, dv) in `dtype` and the final
// f32 state (B, H, dk, dv), in one launch of the chunked form through the
// f32 `scratch` of rwkv6_scratch_floats(B, S, H) and B * H * ceil(S / 64)
// zeroed int flags `ready`. Needs 1 <= dk, dv <= kRwkv6MaxDim and S >= 1.
// Returns the launch error. Does not synchronise.
cudaError_t rwkv6_fwd_launch(const void* r, const void* k, const void* v,
                             const void* w, const float* u, DType dtype,
                             void* out, float* state, float* scratch,
                             int* ready, int64_t B, int64_t S, int64_t H,
                             int64_t dk, int64_t dv, cudaStream_t stream);

// Enqueues the RG-LRU recurrence
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t
// from h_0 = 0 over contiguous x and a (B, S, d): writes h (B, S, d) in
// x's type and the final f32 carry h_last (B, d), one thread per (b, c).
// a is f32 or of x's type. Needs S >= 1 and B <= 65535 (grid.y). Does not
// synchronise; the caller checks cudaGetLastError() right after.
void rglru_fwd_launch(const void* x, DType x_dtype, const void* a,
                      DType a_dtype, void* out, float* h_last, int64_t B,
                      int64_t S, int64_t d, cudaStream_t stream);

// Enqueues the drop-masked ring round of one exchange group (ring.cu): for
// the contiguous (G, n, s, d) payload `stack` (f32 or bf16), (G, n, s) masks
// rs and ag of any of the DType types, the (G, s) f32 divisor `div` and the
// accumulation type `acc_dtype` (kF32 or kBF16), writes out (G, n, s, d) in
// the payload type: block j's rs-gated contributions from `enc` summed in
// ring order owner+1, ..., owner (owner = j % n), divided by div, and
// selected per rank by ag against the rank's own block of `stack`
// (`renorm`) or zero. `enc` is `stack` itself for the plain round, a
// separate table of the payload type (the EF send; scale null) summed in
// acc_dtype, or an int8 table (enc_dtype kI8) times its (G, n, s) f32 row
// `scale`, rounded to the payload type and summed in f32. One thread block
// per (g, j, column tile); needs n >= 1, (2 or, for int8, 3) * n + 1 <=
// kRingSmemFloats and G * s * tiles <= 2^31 - 1. Does not synchronise; the
// caller checks cudaGetLastError() right after.
void ring_round_launch(const void* stack, DType dtype, const void* enc,
                       DType enc_dtype, const float* scale, const void* rs,
                       DType rs_dtype, const void* ag, DType ag_dtype,
                       const float* div, void* out, DType acc_dtype,
                       bool renorm, int64_t G, int64_t n, int64_t s,
                       int64_t d, cudaStream_t stream);

// Enqueues the ring round on the int8 wire that re-encodes the running
// partial per row onto {-levels, ..., levels} before each hop's add
// (ring_q.cu): as ring_round_launch with an int8 `enc` and its `scale`.
// cluster >= 1: one cluster of `cluster` blocks per (g, j) row, each block
// owning `chunk` columns (a multiple of 16, at most kRingQMaxChunk, with
// cluster * chunk >= d) and carrying them as int8 in shared memory;
// `part` and `amax` are unused. cluster == 0 (the wide path): one
// cooperative launch with the f32 scratch `part` (G, s, d) and the zeroed
// row slots `amax` (G * s, n). Returns the launch's error. Does not
// synchronise.
cudaError_t ring_requant_launch(const void* stack, DType dtype,
                                const void* enc, const float* scale,
                                const void* rs, DType rs_dtype,
                                const void* ag, DType ag_dtype,
                                const float* div, void* out, float* part,
                                unsigned int* amax, int levels, bool renorm,
                                int64_t G, int64_t n, int64_t s, int64_t d,
                                int cluster, int64_t chunk,
                                cudaStream_t stream);

// Enqueues one hop of one rank's share of the ring round (ring_rank.cu):
// for chunk `chunk` (rows [chunk * k, (chunk + 1) * k)) of the contiguous
// (S, W) contribution table `src` (f32 or bf16 payload, or int8 with its (S)
// f32 row `src_scale`), the (S) mask row `rs` of any DType type and, after
// the first hop, the received (k, W) partial `recv` (of the accumulation
// type acc_dtype, or int8 with its (k) f32 `recv_scale`), writes the new
// (k, W) partial to `out`: the gated contributions added to the received
// partial in acc_dtype (kF32 or kBF16; f32 for an int8 table). `last`
// divides by the (S) f32 divisor `div` and writes the payload type
// out_dtype (kF32 or kBF16); otherwise `levels` > 0 (int8 table, f32 sums)
// re-encodes each row onto the int8 grid into `out` and its (k) f32
// `out_scale`, and levels == 0 writes acc_dtype. A linear or last hop: one
// launch, a thread block per (row, column tile). A re-encoding hop: each
// row split into `blocks` blocks of `cols` columns (a multiple of 16,
// (blocks - 1) * cols < W <= blocks * cols); one launch when blocks == 1,
// else two, the first writing each block's max|acc| into the (k, blocks)
// f32 scratch `part_max` (unused when blocks == 1). Needs k <= 65535.
// Returns cudaGetLastError() after the last launch (after the first of two
// when it failed). Does not synchronise.
cudaError_t ring_rank_hop_launch(const void* src, DType src_dtype,
                                 const float* src_scale, const void* rs,
                                 DType rs_dtype, const void* recv,
                                 DType recv_dtype, const float* recv_scale,
                                 const float* div, void* out, DType out_dtype,
                                 float* out_scale, float* part_max,
                                 DType acc_dtype, int levels, bool last,
                                 int64_t chunk, int64_t k, int64_t W,
                                 int64_t blocks, int64_t cols,
                                 cudaStream_t stream);

// Enqueues one landing of the ring round's all-gather (ring_rank.cu): the
// averaged (k, W) chunk `cur` (f32 or bf16) written to rows
// [chunk * k, (chunk + 1) * k) of the contiguous (S, W) `out` where the (S)
// mask row `ag` (any DType type) delivered it, and the rank's own rows of
// `blocks` (`renorm`) or zero elsewhere. Needs k <= 65535. Does not
// synchronise; the caller checks cudaGetLastError() right after.
void ring_rank_land_launch(const void* cur, DType dtype, const void* ag,
                           DType ag_dtype, const void* blocks, void* out,
                           bool renorm, int64_t chunk, int64_t k, int64_t W,
                           cudaStream_t stream);

// The re-encoding kernel's cluster path: at most 16 blocks (the
// non-portable cluster size) per row, each carrying at most 192 KiB of
// int8 partial in shared memory.
constexpr int64_t kRingQMaxCluster = 16;
constexpr int64_t kRingQMaxChunk = 196608;

// Floats of shared memory a ring-round block may stage: the 48 KB of the
// static limit.
constexpr int64_t kRingSmemFloats = 12288;

// Columns one ring-round thread block covers at the scalar width; the
// binding sizes the grid's limit with it.
constexpr int64_t kRingTileCols = 256;

}  // namespace repro_torch
