#!/usr/bin/env python3
"""Times variants of the design of ``ring_rank.cu``'s re-encoding hop (the
int8 wire's middle hop on the collective path) on one GPU, beside the
port's kernel (``src/repro_torch/kernels/csrc/ring_rank.cu``).

Each variant is the port's source with one design choice undone, built
from a copy of ``csrc/`` under an op namespace of its own:

- ``port``: the source as it is;
- ``no_pdl``: pass 2 a plain launch, not a programmatic dependent one;
- ``cvt``: conversion instructions again (``float(q)`` on the 16-column
  path, ``rintf`` and a float-to-int conversion in ``encode_fma``);
- ``unroll4``: four pairs of 16-byte loads in flight a thread, not two;
- ``blocks4``: the port's source, its rows split for four blocks per SM
  instead of two (``rank_requant_plan``'s target).

At every chunk shape of rps-100m's int8 exchange at n = 4 that splits
its row (one row of 589,824 to 7,077,888 columns) each variant is held
bit for bit to the plain version (``kernels/ref.py::ring_rank_hop_ref``)
and timed in a CUDA graph between CUDA events over input sets rotated so
that each launch finds its inputs cold (as ``chip_smoke.py`` phase 40b).

    python3 tools/ring_rank_variants.py

Builds each variant with ``torch.utils.cpp_extension.load`` (about 30 s
each) into a temporary directory. Needs a CUDA device; exits non-zero
without one. Prints the card and one JSON object.
"""
from __future__ import annotations

import itertools
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import ring as RG  # noqa: E402

SHAPES = ((1, 589_824), (1, 1_769_472), (1, 3_145_728), (1, 7_077_888))
N = 4                          # ranks: the table holds N chunks
COLD_BYTES = 100_000_000       # between two uses of one input set
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, 700 W

# (file, the port's text, the variant's text) for each edited variant
EDITS = {
    "no_pdl": [("ring_rank.cu", "config.numAttrs = 1;",
                "config.numAttrs = 0;")],
    "cvt": [("ring_rank.cu", "if constexpr (VEC % 4 == 0) {",
             "if constexpr (false) {"),
            ("ring_common.cuh",
             "  const float q = fminf(fmaxf(__fmaf_rn(r, inv, q0), -levels), "
             "levels);\n  return __float_as_int(__fadd_rn(q, 12582912.0f)) - "
             "0x4B400000;",
             "  return static_cast<int>(fminf(fmaxf(rintf(__fmaf_rn(r, inv, "
             "q0)), -levels), levels));")],
    "unroll4": [("ring_rank.cu", "constexpr int kRowUnroll = 2;",
                 "constexpr int kRowUnroll = 4;")],
}


def build_variant(name: str, edits: list, tmp: Path):
    """The variant's ops namespace, built from an edited copy of csrc/."""
    from torch.utils.cpp_extension import load
    src = tmp / name / "csrc"
    shutil.copytree(build.CSRC, src)
    for fname, old, new in edits:
        text = (src / fname).read_text()
        if old not in text:
            raise SystemExit(f"{name}: {fname} no longer holds {old!r}")
        (src / fname).write_text(text.replace(old, new))
    ns = f"rr_{name}"
    for f in src.iterdir():
        f.write_text(f.read_text().replace("repro_torch", ns))
    out = tmp / name / "_build"
    out.mkdir()
    load(name=ns, sources=[str(src / s) for s in build.SOURCES],
         build_directory=str(out), extra_cflags=["-O2"],
         extra_cuda_cflags=list(build.CUDA_FLAGS),
         extra_include_paths=[str(src)], is_python_module=False,
         verbose=False)
    return getattr(torch.ops, ns)


def plan(k: int, W: int, sms: int, per_sm: int) -> tuple:
    """rank_requant_plan's split, its target per_sm blocks a SM."""
    want = -(-per_sm * sms // k)
    blocks = max(1, min(want, W // RG.RANK_MIN_COLS))
    cols = -(-(-(-W // blocks)) // 16) * 16
    return -(-W // cols), cols


def graph_ms(fn, calls: int, reps: int = 5) -> float:
    """Device ms of one fn() call: ``calls`` calls in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (calls * reps)


def time_variant(op, k: int, W: int, blocks: int, cols: int,
                 gen: torch.Generator) -> dict:
    S = N * k
    nbytes = 3 * k * W + 12 * k
    sets = min(64, max(8, -(-COLD_BYTES // nbytes)))
    rs = torch.ones(S, dtype=torch.bool, device="cuda")
    div = torch.full((S,), float(N), device="cuda")
    ins = [(torch.randint(-127, 128, (S, W), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand(S, generator=gen, device="cuda") * 0.1,
            torch.randint(-127, 128, (k, W), generator=gen, device="cuda",
                          dtype=torch.int8),
            torch.rand(k, generator=gen, device="cuda") * 0.5)
           for _ in range(sets)]

    def hop(q, qs, rq, rqs):
        out = torch.empty((k, W), dtype=torch.int8, device="cuda")
        scale = torch.empty((k,), dtype=torch.float32, device="cuda")
        part = torch.empty((k, blocks), dtype=torch.float32,
                           device="cuda") if blocks > 1 else None
        op.ring_rank_hop(q, qs, rs, rq, rqs, div, out, scale, part, 1,
                         False, 127, False, blocks, cols)
        return out, scale

    got = hop(*ins[0])
    want = R.ring_rank_hop_ref(ins[0][0], ins[0][1], rs, ins[0][2],
                               ins[0][3], div, chunk=1, k=k, levels=127)
    bad = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
    it = itertools.cycle(ins)
    ms = graph_ms(lambda: hop(*next(it)), calls=sets)
    return {"ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "blocks": blocks, "cols": cols, "differing": bad}


def main() -> int:
    if not torch.cuda.is_available():
        print("ring_rank_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ops = {"port": build_variant("port", [], Path(tmp))}
        for name, edits in EDITS.items():
            ops[name] = build_variant(name, edits, Path(tmp))
        ops["blocks4"] = ops["port"]
        for name, op in ops.items():
            per_sm = 4 if name == "blocks4" else 2
            res[name] = {f"{k}x{W}": time_variant(op, k, W,
                                                  *plan(k, W, sms, per_sm),
                                                  gen)
                         for k, W in SHAPES}
            torch.cuda.empty_cache()
    bad = sum(v["differing"] for r in res.values() for v in r.values())
    print(json.dumps({"card": card, "variants": res}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
