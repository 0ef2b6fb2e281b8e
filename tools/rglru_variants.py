#!/usr/bin/env python3
"""Times variants of the RG-LRU kernel's design on one GPU, beside the
port's kernel (``src/repro_torch/kernels/csrc/rglru.cu``).

Every variant computes what the port's kernel computes at the
recurrentgemma slice's shape, (8, 2048, 4096) with bf16 x and f32 a: one
thread per channel (or per V neighbouring channels), the loop over t in
chunks of ``U`` steps with the next chunk's x and a loaded into
registers before the current chunk's dependent chain, ``T`` threads per
block. Two kernels:

- ``first``: the port kernel's first form, which converted each
  prefetched step to f32 as it was loaded;
- ``vec``: the prefetched steps kept in their stored types and converted
  at use (the form the port kernel has now), with V channels per thread
  read through the CUDA vector types (``__nv_bfloat162``, ``uint2``;
  ``float2``, ``float4``).

Each variant is held to the plain version (``kernels/ref.py::rglru_ref``)
and timed by CUDA events over 30 launches, in two rounds of alternating
order, beside the port's kernel and a torch yardstick that moves about
the same bytes (a copy of x into h and a sum over a).

    python3 tools/rglru_variants.py

Builds one shared library with ``nvcc`` (``/usr/local/cuda``) into a
temporary directory and calls it through ctypes. Needs a CUDA device;
exits non-zero without one. Prints the card and one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from chip_smoke import RG_SHAPE, card_line, rglru_inputs  # noqa: E402
from repro_torch.kernels import rglru as GK  # noqa: E402
from repro_torch.kernels.ref import rglru_ref  # noqa: E402

NVCC = "/usr/local/cuda/bin/nvcc"
# (kernel, V channels per thread, U steps per chunk, T threads per block)
VARIANTS = [("first", 1, 8, 128), ("first", 1, 16, 128),
            ("first", 1, 32, 128), ("first", 1, 16, 64),
            ("first", 1, 32, 64), ("first", 1, 16, 256),
            ("vec", 1, 8, 128), ("vec", 2, 8, 128), ("vec", 4, 8, 128),
            ("vec", 2, 16, 64), ("vec", 4, 8, 64), ("vec", 4, 16, 32)]

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

// the first form: every prefetched step converted to f32 as it is loaded
template <int U, int T>
__global__ void __launch_bounds__(T) first_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
    __nv_bfloat16* __restrict__ out, float* __restrict__ h_last, int S,
    int d) {
  const int c = blockIdx.x * T + threadIdx.x;
  if (c >= d) return;
  const int64_t b = blockIdx.y;
  const int64_t base = b * S * d + c;
  float nx[U], na[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    nx[u] = 0.0f;
    na[u] = 0.0f;
    if (u < S) {
      nx[u] = __bfloat162float(x[base + (int64_t)u * d]);
      na[u] = a[base + (int64_t)u * d];
    }
  }
  float h = 0.0f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float cx[U], ca[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cx[u] = nx[u];
      ca[u] = na[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + U + u < S) {
        const int64_t off = base + (int64_t)(t0 + U + u) * d;
        nx[u] = __bfloat162float(x[off]);
        na[u] = a[off];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        const float at = ca[u];
        const float bt = sqrtf(fmaxf(1.0f - at * at, 0.0f)) * cx[u];
        h = at * h + bt;
        out[base + (int64_t)(t0 + u) * d] = __float2bfloat16(h);
      }
    }
  }
  h_last[b * d + c] = h;
}

template <int V> struct XVec;
template <> struct XVec<1> { using T = __nv_bfloat16; };
template <> struct XVec<2> { using T = __nv_bfloat162; };
template <> struct XVec<4> { using T = uint2; };
template <int V> struct AVec;
template <> struct AVec<1> { using T = float; };
template <> struct AVec<2> { using T = float2; };
template <> struct AVec<4> { using T = float4; };

// the prefetched steps kept as stored, V channels per thread
template <int V, int U, int T>
__global__ void __launch_bounds__(T) vec_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
    __nv_bfloat16* __restrict__ out, float* __restrict__ h_last, int S,
    int d) {
  using XT = typename XVec<V>::T;
  using AT = typename AVec<V>::T;
  const int c = (blockIdx.x * T + threadIdx.x) * V;
  if (c >= d) return;
  const int64_t b = blockIdx.y;
  const int64_t base = b * S * d + c;
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = 0.0f;
  XT nx[U];
  AT na[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < S) {
      nx[u] = *reinterpret_cast<const XT*>(x + base + (int64_t)u * d);
      na[u] = *reinterpret_cast<const AT*>(a + base + (int64_t)u * d);
    }
  }
  for (int t0 = 0; t0 < S; t0 += U) {
    XT cx[U];
    AT ca[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cx[u] = nx[u];
      ca[u] = na[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + U + u < S) {
        const int64_t off = base + (int64_t)(t0 + U + u) * d;
        nx[u] = *reinterpret_cast<const XT*>(x + off);
        na[u] = *reinterpret_cast<const AT*>(a + off);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        const __nv_bfloat16* xs =
            reinterpret_cast<const __nv_bfloat16*>(&cx[u]);
        const float* as = reinterpret_cast<const float*>(&ca[u]);
        XT o;
        __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float at = as[v];
          h[v] = at * h[v] +
                 sqrtf(fmaxf(1.0f - at * at, 0.0f)) * __bfloat162float(xs[v]);
          os[v] = __float2bfloat16(h[v]);
        }
        *reinterpret_cast<XT*>(out + base + (int64_t)(t0 + u) * d) = o;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) h_last[b * d + c + v] = h[v];
}

template <int U, int T>
int run_first(const void* x, const void* a, void* out, float* hl,
              long long B, long long S, long long d, void* stream) {
  const dim3 grid((unsigned)((d + T - 1) / T), (unsigned)B);
  first_kernel<U, T><<<grid, T, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)a, (__nv_bfloat16*)out, hl,
      (int)S, (int)d);
  return (int)cudaGetLastError();
}

template <int V, int U, int T>
int run_vec(const void* x, const void* a, void* out, float* hl, long long B,
            long long S, long long d, void* stream) {
  const dim3 grid((unsigned)((d / V + T - 1) / T), (unsigned)B);
  vec_kernel<V, U, T><<<grid, T, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)a, (__nv_bfloat16*)out, hl,
      (int)S, (int)d);
  return (int)cudaGetLastError();
}

extern "C" int variant_launch(int i, const void* x, const void* a, void* out,
                              float* hl, long long B, long long S,
                              long long d, void* stream) {
  switch (i) {
CASES
  }
  return -1;
}
"""


def name(v) -> str:
    kernel, V, U, T = v
    return f"{kernel} V{V} U{U} T{T}"


def case(i: int, v) -> str:
    kernel, V, U, T = v
    tmpl = f"{U}, {T}" if kernel == "first" else f"{V}, {U}, {T}"
    return (f"    case {i}: return run_{kernel}<{tmpl}>"
            f"(x, a, out, hl, B, S, d, stream);")


def build(tmp: Path) -> ctypes.CDLL:
    cases = "\n".join(case(i, v) for i, v in enumerate(VARIANTS))
    src = tmp / "rglru_variants.cu"
    src.write_text(SOURCE.replace("CASES", cases))
    lib = tmp / "librglru_variants.so"
    subprocess.run([NVCC, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.variant_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                   + [ctypes.c_longlong] * 3
                                   + [ctypes.c_void_p])
    dll.variant_launch.restype = ctypes.c_int
    return dll


def event_ms(fn, n: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("rglru_variants: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    B, S, d = RG_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x, a = rglru_inputs(gen, B, S, d, torch.bfloat16)
    h_ref, last_ref = rglru_ref(x, a)
    out = torch.empty_like(x)
    h_last = torch.empty((B, d), dtype=torch.float32, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        dll = build(Path(tmp))

        def variant(i):
            def call():
                rc = dll.variant_launch(
                    i, x.data_ptr(), a.data_ptr(), out.data_ptr(),
                    h_last.data_ptr(), B, S, d,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name(VARIANTS[i])}: CUDA error "
                                       f"{rc}")
            return call

        fns = [(name(v), variant(i)) for i, v in enumerate(VARIANTS)]
        res = {}
        for nm, fn in fns:
            fn()
            torch.cuda.synchronize()
            if not (torch.allclose(out.float(), h_ref.float(), atol=1e-6,
                                   rtol=2.0 ** -7)
                    and torch.allclose(h_last, last_ref, atol=1e-5,
                                       rtol=1e-5)):
                raise AssertionError(f"{nm} disagrees with the plain "
                                     f"version")
            res[nm] = []
        fns.append(("port kernel (rglru.cu)", lambda: GK.rglru(x, a)))
        fns.append(("torch yardstick: copy x to h, sum a",
                    lambda: (out.copy_(x), a.sum())))
        res[fns[-2][0]], res[fns[-1][0]] = [], []
        for rnd in range(2):
            for nm, fn in (fns if rnd == 0 else fns[::-1]):
                res[nm].append(event_ms(fn))
    print(json.dumps({"card": card, "shape": [B, S, d],
                      "x": "bfloat16", "a": "float32", "ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
