// RWKV-6 (Finch) recurrence for Hopper (sm_90a), in the chunked form on
// tensor cores.
//
// Replaces src/repro/kernels/rwkv6_scan.py::rwkv6_pallas (body
// _rwkv6_kernel): from a zero state, for every (b, h),
//   o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
// with the (dk, dv) state in f32, inputs read in their own type (f32, bf16,
// f16) and o written in it. It also writes the final state, which the TPU
// kernel keeps in its VMEM scratch: the model's prefill takes it as the
// decode cache.
//
// The chunked form (the TPU kernel's): with chunks of C = 64 tokens and
// la = cumsum(log2 w) inside a chunk (w clipped to [1e-30, 1] first),
// la_prev the exclusive sum and la_C its last row,
//   o     = scores @ v + (r . exp2(la_prev)) @ S_in
//   scores[t, s] = sum_k r[t,k] k[s,k] exp2(la_prev[t,k] - la[s,k]), s < t
//   scores[t, t] = sum_k r[t,k] u[k] k[t,k]             (the bonus)
//   S_out = S_in . exp2(la_C) + (k . exp2(la_C - la))^T @ v
// Every exponent evaluated is <= 0. The pairwise decay is not a matrix
// product: inside a block of 8 tokens it is taken pair by pair; for s in
// an earlier block than t's it is factored at a token x between them, the
// last one before t's 16-token sub-chunk (or, within a sub-chunk, before
// its second 8 tokens):
//   exp2(la_prev[t] - la[s]) = exp2(la_prev[t] - la[x])
//                              * exp2(la[x] - la[s]),
// both factors <= 1. (Never around a chunk's start, where exp2(-la[s])
// overflows for small w.)
//
// What bounds it: per (b, t, h) the recurrence does about 6 operations for
// each of the dk * dv state entries and reads dk + dk + dk + dv inputs; at
// the serving shape (8, 512, 32, 64) bf16 that is 3.22 GFLOP against 88.1
// MB, 0.026 ms of HBM traffic and 0.0065 ms of the same operations at the
// card's 495 TFLOP/s of TF32 tensor-core work (0.048 ms on the f32 cores
// outside them), at an H100 SXM's data-sheet rates (700 W): bytes. The
// sequential form is bound by neither: 512 dependent steps per (b, h).
//
// What the design does about it: one launch of one block of 8 warps per
// (b, h, chunk) (2,048 blocks at the serving shape, against 256 of at most
// 2 warps for the sequential form), in (chunk, b, h) order, so neighbouring
// blocks read neighbouring heads of the same tokens and a chunk's blocks
// run after the previous chunk's, whose states they wait for. A block
//   0. computes its chunk's own state contribution
//      U_c = (k . exp2(la_C - la))^T @ v;
//   1.-3. its scores (the off-diagonal tiles, the pairwise diagonal blocks
//      and the bonus) and scores @ v, the work dealt evenly over the warps;
//   4. takes the carry-in S_{c-1} from the block of chunk c - 1 (a flag
//      per chunk, acquire / release) and passes on
//      S_c = S_{c-1} . exp2(la_C) + U_c, so the scan over chunks is a
//      chain of short steps that the blocks reach after their own work;
//      the last chunk's S_c is the final state;
//   5. adds the carry-in (r . exp2(la_prev)) @ S_{c-1} and writes o.
// The matrix products run on the tensor cores as mma.sync m16n8k8 in
// split TF32 (3xTF32: a = hi + lo, a b ~ hi hi + hi lo + lo hi) with f32
// accumulators, about f32 accuracy; the decay factors are applied in f32
// before the operands are split. One TF32 product would miss the state's
// 2e-4 and the f32 output's 2e-4, and for bf16 inputs it left little
// margin in chip_smoke.py's prefill-against-decode check (phase 8). A
// block's tiles are loaded in 16-byte loads that are all in flight
// together and staged in shared memory as f32 with a row pitch of 72
// floats, which keeps the fragment loads free of bank conflicts. dk and dv
// are padded to 64 (r = k = v = 0, log2 w = 0) and S to whole chunks (the
// same), so the padded rows and tokens add nothing; only real entries are
// written.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "convert.cuh"
#include "kernels.h"

namespace repro_torch {
namespace {

constexpr int kC = 64;          // tokens per chunk
constexpr int kD = 64;          // dk and dv, padded
constexpr int kP = 72;          // shared-memory row pitch in floats
constexpr int kSubs = kC / 16;  // 16-token sub-chunks (16 state rows)
constexpr int kWarps = 2 * kSubs;  // warps of a block
constexpr int kThreadsC = 32 * kWarps;
constexpr int kTile = kC * kP;  // floats of one staged (64, 64) operand

// the f32 value split into two TF32 values, hi + lo ~ x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x with one multi-function unit instruction (relative error about
// 2^-22; results below 2^-126 flush to zero, where the terms they scale
// are negligible); every x here is <= 0
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// An A fragment split for split-TF32 products: the (16, 8) f32 values
// a[0] at (g, q), a[1] at (g + 8, q), a[2] at (g, q + 4), a[3] at
// (g + 8, q + 4), with g = lane / 4, q = lane % 4.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit FragA(const float (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], hi[i], lo[i]);
  }
};

// d += a b in split TF32. b: the (8, 8) B fragment, b[0] at (q, g), b[1] at
// (q + 4, g); d: d[0], d[1] at (g, 2q), (g, 2q + 1), d[2], d[3] at
// (g + 8, 2q), (g + 8, 2q + 1).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  mma_tf32(d, a.lo, bh);
  mma_tf32(d, a.hi, bl);
  mma_tf32(d, a.hi, bh);
}

// One chunk's (64, 64) tile of x (B, S, H, dim) into shared memory as f32,
// rows = tokens, zero past S and dim, each value passed through `f`: the
// element-wise path for a head narrower than 64 or an unaligned input.
// Every load of a thread is issued before its stores.
template <int THREADS, typename T, typename F>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ x,
                                      int64_t b, int64_t t0, int64_t S,
                                      int64_t H, int64_t h, int dim, F f) {
  constexpr int kIters = kC * kD / THREADS;
  float vals[kIters];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = it * THREADS + threadIdx.x;
    const int t = i / kD, e = i % kD;
    const int64_t tok = t0 + t;
    vals[it] = tok < S && e < dim
                   ? f(to_float(x[((b * S + tok) * H + h) * dim + e]))
                   : 0.0f;
  }
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = it * THREADS + threadIdx.x;
    dst[(i / kD) * kP + i % kD] = vals[it];
  }
}

// One thread's share of a chunk's (64, 64) tile of x (B, S, H, 64), as
// 16-byte loads (zero past S): load() issues them all, store() converts
// and writes them to shared memory, so a kernel can have every tile of a
// chunk in flight at once. Needs x aligned to 16 bytes.
template <int THREADS, typename T>
struct TileLoad {
  static constexpr int kVec = static_cast<int>(sizeof(uint4) / sizeof(T));
  static constexpr int kIters = kC * kD / kVec / THREADS;
  uint4 raw[kIters];

  __device__ __forceinline__ void load(const T* __restrict__ x, int64_t b,
                                       int64_t t0, int64_t S, int64_t H,
                                       int64_t h) {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = (it * THREADS + threadIdx.x) * kVec;
      const int64_t tok = t0 + i / kD;
      raw[it] = tok < S ? __ldg(reinterpret_cast<const uint4*>(
                              x + ((b * S + tok) * H + h) * kD + i % kD))
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  template <typename F>
  __device__ __forceinline__ void store(float* dst, int64_t t0, int64_t S,
                                        F f) const {
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int i = (it * THREADS + threadIdx.x) * kVec;
      const bool real = t0 + i / kD < S;
      T vals[kVec];
      memcpy(vals, &raw[it], sizeof(uint4));
      float4* row = reinterpret_cast<float4*>(dst + (i / kD) * kP + i % kD);
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        row[e / 4] = real ? make_float4(f(to_float(vals[e])),
                                        f(to_float(vals[e + 1])),
                                        f(to_float(vals[e + 2])),
                                        f(to_float(vals[e + 3])))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
};

struct Identity {
  __device__ __forceinline__ float operator()(float x) const { return x; }
};
// log2 of the decay clipped to [1e-30, 1], as the TPU kernel clips it
struct Log2Decay {
  __device__ __forceinline__ float operator()(float x) const {
    return log2f(fminf(fmaxf(x, 1e-30f), 1.0f));
  }
};

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % sizeof(uint4) == 0;
}

// la of one chunk in sla (65 rows), from the log2 decays staged in rows
// 1..64: row 0 becomes zero (la before the chunk), row t + 1 the inclusive
// sum to token t; so la_prev[t] = sla[t] and la[t] = sla[t + 1]. Thread
// (part, e) sums column e over the part's 16 rows in registers; part p then
// adds base_p = base_{p-1} + (part p - 1's sum), which is exactly the
// stored last row of part p - 1. So the sums only grow more negative down
// a column and every la_prev[t] - la[s] with s < t is <= 0. Starts and
// ends with a barrier.
template <int THREADS>
__device__ __forceinline__ void la_scan(float* sla) {
  constexpr int kParts = THREADS / kD;
  constexpr int kRows = kC / kParts;
  __shared__ float s_total[kParts][kD];
  __syncthreads();
  const int e = threadIdx.x % kD, part = threadIdx.x / kD;
  float run[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) run[i] = sla[(1 + part * kRows + i) * kP + e];
#pragma unroll
  for (int i = 1; i < kRows; ++i) run[i] += run[i - 1];
  s_total[part][e] = run[kRows - 1];
  __syncthreads();
  float base = 0.0f;
  for (int p = 0; p < part; ++p) base += s_total[p][e];
  if (part == 0) sla[e] = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    sla[(1 + part * kRows + i) * kP + e] = base + run[i];
  __syncthreads();
}

// acquire / release flags between the blocks of one (b, h)
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// One block per (b, h, chunk c), 8 warps, blocks in (c, b, h) order.
// `chain` holds each chunk's outgoing state S_c (f32, (64, 64)) and
// `ready` (zeroed by the caller) its flag: the block of chunk c waits for
// chunk c - 1's flag, which belongs to a block of a lower index, so it was
// dispatched first and finishes without waiting on this one.
template <typename T>
__global__ void __launch_bounds__(kThreadsC, 2)
    rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ w,
                       const float* __restrict__ u, float* chain, int* ready,
                       T* __restrict__ out, float* __restrict__ state,
                       int64_t S, int64_t H, int dk, int dv, int64_t nc) {
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;
  float* sk = sr + kTile;
  float* sv = sk + kTile;
  float* sS = sv + kTile;    // U_c, then the carry-in; rows k, columns v
  float* ssc = sS + kTile;   // the scores, rows t, columns s
  float* sla = ssc + kTile;  // 65 rows
  float* su = sla + (kC + 1) * kP;
  // blocks in (chunk, b, h) order: neighbouring blocks read neighbouring
  // heads of the same tokens, and a chunk's blocks start after the
  // previous chunk's
  const int64_t B = gridDim.x / (H * nc);
  const int64_t h = blockIdx.x % H;
  const int64_t b = (blockIdx.x / H) % B;
  const int64_t c = blockIdx.x / (H * B);
  const int64_t bh = b * H + h;
  const int64_t item = bh * nc + c;  // its slot of `chain` and `ready`
  const int64_t tc = c * kC;
  if (dk == kD && dv == kD && aligned16(r) && aligned16(k) && aligned16(v) &&
      aligned16(w)) {
    TileLoad<kThreadsC, T> lr, lk, lv, lw;
    lr.load(r, b, tc, S, H, h);
    lk.load(k, b, tc, S, H, h);
    lv.load(v, b, tc, S, H, h);
    lw.load(w, b, tc, S, H, h);
    lr.store(sr, tc, S, Identity());
    lk.store(sk, tc, S, Identity());
    lv.store(sv, tc, S, Identity());
    lw.store(sla + kP, tc, S, Log2Decay());
  } else {
    stage<kThreadsC>(sr, r, b, tc, S, H, h, dk, Identity());
    stage<kThreadsC>(sk, k, b, tc, S, H, h, dk, Identity());
    stage<kThreadsC>(sv, v, b, tc, S, H, h, dv, Identity());
    stage<kThreadsC>(sla + kP, w, b, tc, S, H, h, dk, Log2Decay());
  }
  if (threadIdx.x < kD)
    su[threadIdx.x] =
        static_cast<int>(threadIdx.x) < dk ? u[h * dk + threadIdx.x] : 0.0f;
  la_scan<kThreadsC>(sla);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;

  // 0. the chunk's own state contribution U_c = (k . exp2(la_C - la))^T @ v
  // into sS: warp w takes U rows 16 (w / 2) .., 32 columns from 32 (w % 2)
  {
    const int m0 = 16 * (warp / 2), c0 = 32 * (warp % 2);
    const float* la_c = sla + kC * kP;
    float acc[4][4] = {};
#pragma unroll 2
    for (int kt = 0; kt < kC / 8; ++kt) {  // over tokens s
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + g + (i & 1) * 8;     // k index
        const int s = kt * 8 + q + (i >> 1) * 4;  // token
        a[i] = sk[s * kP + row] *
               exp2_fast(la_c[row] - sla[(s + 1) * kP + row]);
      }
      const FragA fa(a);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float bf[2] = {sv[(kt * 8 + q) * kP + c0 + nt * 8 + g],
                             sv[(kt * 8 + q + 4) * kP + c0 + nt * 8 + g]};
        mma3(acc[nt], fa, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c0 + nt * 8 + 2 * q;
      sS[(m0 + g) * kP + col] = acc[nt][0];
      sS[(m0 + g) * kP + col + 1] = acc[nt][1];
      sS[(m0 + g + 8) * kP + col] = acc[nt][2];
      sS[(m0 + g + 8) * kP + col + 1] = acc[nt][3];
    }
  }

  // 1. scores[t, s] for s in an earlier 16-token sub-chunk than t's (which
  // starts at t0), factored at t0 - 1: the 12 (16, 8) tiles of the three
  // later sub-chunks, warp w taking tiles w and w + 8
  for (int id = warp; id < 12; id += kWarps) {
    const int sub = id < 2 ? 1 : (id < 6 ? 2 : 3);
    const int nt = id - (sub == 1 ? 0 : (sub == 2 ? 2 : 6));
    const int t0 = 16 * sub;
    const float* ref = sla + t0 * kP;  // la[t0 - 1]
    float sacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int kt = 0; kt < kD / 8; ++kt) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + g + (i & 1) * 8;
        const int e = kt * 8 + q + (i >> 1) * 4;
        a[i] = sr[t * kP + e] * exp2_fast(sla[t * kP + e] - ref[e]);
      }
      const int s = nt * 8 + g;
      const int e0 = kt * 8 + q, e1 = e0 + 4;
      const float bf[2] = {
          sk[s * kP + e0] * exp2_fast(ref[e0] - sla[(s + 1) * kP + e0]),
          sk[s * kP + e1] * exp2_fast(ref[e1] - sla[(s + 1) * kP + e1])};
      mma3(sacc, FragA(a), bf);
    }
    const int col = nt * 8 + 2 * q;
    ssc[(t0 + g) * kP + col] = sacc[0];
    ssc[(t0 + g) * kP + col + 1] = sacc[1];
    ssc[(t0 + g + 8) * kP + col] = sacc[2];
    ssc[(t0 + g + 8) * kP + col + 1] = sacc[3];
  }

  // 2. each sub-chunk's own 16 x 16 block. Its two 8-token diagonal
  // blocks (warp w: sub-chunk w / 2, block w % 2) pair by pair: lane l
  // holds k = l and l + 32 of the block's rows in registers and sums its
  // share of the 28 pairs s < t (the pairwise decay) and the 8 bonus terms
  // s == t, then the warp adds the shares up: the first 32 sums by halving
  // (each step a lane sends half its sums to its partner and keeps the
  // other half, so lane l ends with sum l), the last 4 by a plain
  // reduction. The 8 x 8 block of tokens t0 + 8.. against t0.. (warp
  // 4 + sub-chunk) is a product factored at token t0 + 7 (both factors
  // <= 1). Zero above the diagonal.
  {
    const int sub = warp / 2, half = warp % 2;
    const int base = 16 * sub + 8 * half;  // the diagonal block's first token
    const int e0 = lane, e1 = lane + 32;
    float k0[8], k1[8], l0[8], l1[8];  // k[s], la[s] of the block's tokens
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      k0[n] = sk[(base + n) * kP + e0];
      k1[n] = sk[(base + n) * kP + e1];
      l0[n] = sla[(base + n + 1) * kP + e0];
      l1[n] = sla[(base + n + 1) * kP + e1];
    }
    // sums 0..27: pair (m, n), n < m, at m (m - 1) / 2 + n; 28..35: bonus m
    float val[36];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float r0 = sr[(base + m) * kP + e0], r1 = sr[(base + m) * kP + e1];
      const float p0 = sla[(base + m) * kP + e0];  // la_prev[t]
      const float p1 = sla[(base + m) * kP + e1];
#pragma unroll
      for (int n = 0; n < m; ++n)
        val[m * (m - 1) / 2 + n] = r0 * k0[n] * exp2_fast(p0 - l0[n]) +
                                   r1 * k1[n] * exp2_fast(p1 - l1[n]);
      val[28 + m] = r0 * su[e0] * k0[m] + r1 * su[e1] * k1[m];
    }
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < o; ++i) {
        const float send = upper ? val[i] : val[i + o];
        const float keep = upper ? val[i + o] : val[i];
        val[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
#pragma unroll
    for (int j = 32; j < 36; ++j) {
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        val[j] += __shfl_xor_sync(0xffffffffu, val[j], o);
    }
    if (lane < 28) {
      int m = 1;
      while ((m + 1) * m / 2 <= lane) ++m;
      const int n = lane - m * (m - 1) / 2;
      ssc[(base + m) * kP + base + n] = val[0];
    } else {
      const int m = lane - 28;
      ssc[(base + m) * kP + base + m] = val[0];
    }
    if (lane < 4) {
      const int m = 4 + lane;
      const float bonus = lane == 0 ? val[32]
                          : lane == 1 ? val[33]
                          : lane == 2 ? val[34] : val[35];
      ssc[(base + m) * kP + base + m] = bonus;
    }
    // zero above the diagonal in the block's 8 rows of the 16 x 16 block
    for (int p = lane; p < 128; p += 32) {
      const int m = p / 16, n = p % 16;  // row base + m, column 16 sub + n
      if (n > 8 * half + m) ssc[(base + m) * kP + 16 * sub + n] = 0.0f;
    }
  }
  if (warp >= kWarps - kSubs) {
    // rows t0 + 8 + g against columns t0 + g, the A fragment's upper rows
    // zero; la[t0 + 7] = sla[t0 + 8]
    const int t0 = 16 * (warp - (kWarps - kSubs));
    const float* ref = sla + (t0 + 8) * kP;
    float dacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
    for (int kt = 0; kt < kD / 8; ++kt) {
      const int e0 = kt * 8 + q, e1 = e0 + 4;
      const int t = t0 + 8 + g, s = t0 + g;
      const float a[4] = {
          0.0f, sr[t * kP + e0] * exp2_fast(sla[t * kP + e0] - ref[e0]),
          0.0f, sr[t * kP + e1] * exp2_fast(sla[t * kP + e1] - ref[e1])};
      const float bf[2] = {
          sk[s * kP + e0] * exp2_fast(ref[e0] - sla[(s + 1) * kP + e0]),
          sk[s * kP + e1] * exp2_fast(ref[e1] - sla[(s + 1) * kP + e1])};
      mma3(dacc, FragA(a), bf);
    }
    ssc[(t0 + 8 + g) * kP + t0 + 2 * q] = dacc[2];
    ssc[(t0 + 8 + g) * kP + t0 + 2 * q + 1] = dacc[3];
  }
  __syncthreads();  // the scores, written by every warp

  // 3. o = scores @ v over s < t0 + 16. Warp w takes 16 output columns
  // (16 (w % 4) ..) of two sub-chunks, 0 and 3 or 1 and 2, so that every
  // warp does as many products.
  const int n0 = 16 * (warp % 4);
  float oacc[2][2][4] = {};
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const int sub = warp < 4 ? (which == 0 ? 0 : 3) : (which == 0 ? 1 : 2);
    const int t0 = 16 * sub;
    for (int kt = 0; kt < (t0 + 16) / 8; ++kt) {
      const float a[4] = {ssc[(t0 + g) * kP + kt * 8 + q],
                          ssc[(t0 + g + 8) * kP + kt * 8 + q],
                          ssc[(t0 + g) * kP + kt * 8 + q + 4],
                          ssc[(t0 + g + 8) * kP + kt * 8 + q + 4]};
      const FragA fa(a);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float bf[2] = {sv[(kt * 8 + q) * kP + n0 + nt * 8 + g],
                             sv[(kt * 8 + q + 4) * kP + n0 + nt * 8 + g]};
        mma3(oacc[which][nt], fa, bf);
      }
    }
  }

  // 4. the chain: S_in = S_{c-1} from the previous chunk's block (zero for
  // chunk 0), S_c = S_in . exp2(la_C) + U_c out to the next; S_in replaces
  // U_c in sS. Thread i owns the entries i, i + 256, ... of the state.
  if (c > 0 && threadIdx.x == 0) {
    while (load_acquire(ready + item - 1) == 0) {
    }
  }
  __syncthreads();
  {
    constexpr int kPer = kD * kD / kThreadsC;
    const float* prev = chain + (item - 1) * (kD * kD);
    float* next = chain + item * (kD * kD);
    const float* la_c = sla + kC * kP;
    float s_in[kPer];  // every load in flight before any is used
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      s_in[j] = c > 0 ? __ldcg(prev + j * kThreadsC + threadIdx.x) : 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = j * kThreadsC + threadIdx.x;
      const int row = i / kD, col = i % kD;
      const float s_out = __fadd_rn(__fmul_rn(s_in[j], exp2_fast(la_c[row])),
                                    sS[row * kP + col]);
      __stcg(next + i, s_out);
      sS[row * kP + col] = s_in[j];
      if (c == nc - 1 && row < dk && col < dv)
        state[(bh * dk + row) * dv + col] = s_out;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(ready + item, 1);

  // 5. o += (r . exp2(la_prev)) @ S_in (nothing to carry into chunk 0)
  if (c > 0) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const int sub = warp < 4 ? (which == 0 ? 0 : 3) : (which == 0 ? 1 : 2);
      const int t0 = 16 * sub;
#pragma unroll 2
      for (int kt = 0; kt < kD / 8; ++kt) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + g + (i & 1) * 8;
          const int e = kt * 8 + q + (i >> 1) * 4;
          a[i] = sr[t * kP + e] * exp2_fast(sla[t * kP + e]);
        }
        const FragA fa(a);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float bf[2] = {sS[(kt * 8 + q) * kP + n0 + nt * 8 + g],
                               sS[(kt * 8 + q + 4) * kP + n0 + nt * 8 + g]};
          mma3(oacc[which][nt], fa, bf);
        }
      }
    }
  }

  // 6. the real tokens and columns of o
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const int sub = warp < 4 ? (which == 0 ? 0 : 3) : (which == 0 ? 1 : 2);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int64_t tok = tc + 16 * sub + g + hr * 8;
      if (tok >= S) continue;
      T* dst = out + ((b * S + tok) * H + h) * dv;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + nt * 8 + 2 * q;
        const float* o = oacc[which][nt];
        if (col < dv) dst[col] = from_float<T>(o[2 * hr]);
        if (col + 1 < dv) dst[col + 1] = from_float<T>(o[2 * hr + 1]);
      }
    }
  }
}

constexpr size_t kSmem = (5 * kTile + (kC + 1) * kP + kD) * sizeof(float);

template <typename T>
cudaError_t launch_typed(const void* r, const void* k, const void* v,
                         const void* w, const float* u, void* out,
                         float* state, float* scratch, int* ready, int64_t B,
                         int64_t S, int64_t H, int64_t dk, int64_t dv,
                         cudaStream_t stream) {
  const int64_t nc = (S + kC - 1) / kC;
  auto* kernel = &rwkv6_chunk_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(B * H * nc), kThreadsC, kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, scratch, ready,
      static_cast<T*>(out), state, S, H, static_cast<int>(dk),
      static_cast<int>(dv), nc);
  return cudaGetLastError();
}

}  // namespace

int64_t rwkv6_scratch_floats(int64_t B, int64_t S, int64_t H) {
  return B * H * ((S + kC - 1) / kC) * (kD * kD);
}

cudaError_t rwkv6_fwd_launch(const void* r, const void* k, const void* v,
                             const void* w, const float* u, DType dtype,
                             void* out, float* state, float* scratch,
                             int* ready, int64_t B, int64_t S, int64_t H,
                             int64_t dk, int64_t dv, cudaStream_t stream) {
  switch (dtype) {
    case DType::kF32:
      return launch_typed<float>(r, k, v, w, u, out, state, scratch, ready, B,
                                 S, H, dk, dv, stream);
    case DType::kBF16:
      return launch_typed<__nv_bfloat16>(r, k, v, w, u, out, state, scratch,
                                         ready, B, S, H, dk, dv, stream);
    case DType::kF16:
      return launch_typed<__half>(r, k, v, w, u, out, state, scratch, ready,
                                  B, S, H, dk, dv, stream);
    default:
      return cudaErrorInvalidValue;  // the binding admits only these three
  }
}

}  // namespace repro_torch
