"""Count what a step launches and what it sends (the port's counterpart of
``tools/check_hlo.py``).

Schedule regressions are silent: an exchange that falls back to two
collectives per leaf instead of per bucket, or a hand-written kernel
replaced by a library call or by its plain version, still trains
correctly, only slower. The JAX package lowers its program and counts
ops in the text; the port has no program text, so it counts what runs:

- :func:`launch_counts` runs a function under ``torch.profiler`` with
  CUDA activity and returns the device kernels it launched, by symbol
  (it raises without a card); :func:`kernel_launches` maps them onto the
  hand-written kernels' wrappers (:data:`KERNEL_SYMBOLS`), which a
  wrapper's own counter cannot see bypassed;
- :func:`collective_counts` counts ``core/comm.py``'s records (a
  ``comm.recording()`` scope's) under
  ``check_hlo.COLLECTIVE_OPS``' keys (the op the JAX package's program
  has there), on any device, the meta device's dry-run included.

:func:`assert_counts` and :func:`assert_fused_per_bucket` are the loud
failures, as the JAX package's.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Iterable, Optional

import torch

#: op keys understood by :func:`collective_counts`
COLLECTIVE_OPS = ("reduce_scatter", "all_gather", "collective_permute",
                  "all_reduce", "all_to_all")

#: the device symbols each hand-written kernel's wrapper launches
#: (``csrc/*.cu``): ``ring_round_enc`` without a re-encode runs
#: ``ring.cu``'s kernel, and a re-encoding hop split over the card runs
#: ``ring_rank_requant_kernel`` twice (its maxima, then the encode)
KERNEL_SYMBOLS = {
    "masked_avg_grid": ("masked_avg_grid_kernel",),
    "tp_combine": ("tp_combine_kernel",),
    "rwkv6": ("rwkv6_chunk_kernel",),
    "rglru": ("rglru_fwd_kernel",),
    "ring_round": ("ring_round_kernel",),
    "ring_round_enc": ("ring_requant_cluster_kernel",
                       "ring_requant_kernel"),
    "ring_rank_hop": ("ring_rank_hop_kernel", "ring_rank_requant_kernel"),
    "ring_rank_land": ("ring_rank_land_kernel",),
}


def launch_counts(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """The device kernels ``fn(*args, **kwargs)`` launched, ``{symbol:
    count}`` from ``torch.profiler``'s CUDA activity (memsets and copies
    apart; no CPU activity, and the profiler's raw events, unparsed: a
    training step launches tens of thousands of kernels). Raises without
    a card, and when the profiler saw no device event at all (a machine
    whose CUPTI traces nothing)."""
    if not torch.cuda.is_available():
        raise RuntimeError("launch_counts needs a CUDA device: the launches "
                           "are read from the profiler's device trace")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args, **kwargs)
        torch.cuda.synchronize()
    counts: Dict[str, int] = {}
    seen = 0
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != DeviceType.CUDA:
            continue
        seen += 1
        name = evt.name()
        if name.startswith(("Memset", "Memcpy")):
            continue
        counts[name] = counts.get(name, 0) + 1
    if not seen:
        raise RuntimeError("the profiler recorded no device event")
    return counts


def kernel_launches(counts: Dict[str, int]) -> Dict[str, int]:
    """The launches of each hand-written kernel's symbols among
    ``counts`` (:func:`launch_counts`), by wrapper name."""
    out = {}
    for wrapper, symbols in KERNEL_SYMBOLS.items():
        pats = [re.compile(r"\b%s\b" % s) for s in symbols]
        out[wrapper] = sum(c for name, c in counts.items()
                           if any(p.search(name) for p in pats))
    return out


def collective_counts(records: Iterable) -> Dict[str, int]:
    """``{op: count}`` over :data:`COLLECTIVE_OPS` of ``core/comm.py``'s
    records (the list a ``comm.recording()`` scope gathered)."""
    out = {op: 0 for op in COLLECTIVE_OPS}
    for op, _, _ in records:
        out[op] += 1
    return out


def summarize(records: Iterable = (),
              launches: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """The collective counts, and with ``launches`` (a profile's
    :func:`launch_counts`) each hand-written kernel's launches and
    ``kernels``, every device kernel launched."""
    out = dict(collective_counts(records))
    if launches is not None:
        out.update(kernel_launches(launches))
        out["kernels"] = sum(launches.values())
    return out


def assert_counts(records: Iterable = (),
                  launches: Optional[Dict[str, int]] = None,
                  **expected: int) -> Dict[str, int]:
    """Assert exact counts (keys from :func:`summarize`); returns the
    whole summary so callers can log it."""
    got = summarize(records, launches)
    bad = {k: (got.get(k), v) for k, v in expected.items()
           if got.get(k) != v}
    if bad:
        raise AssertionError(
            "launch / collective count mismatch (got, want): " + repr(bad)
            + " | full summary: " + repr(got))
    return got


def assert_fused_per_bucket(launches: Dict[str, int], n_buckets: int,
                            per_bucket: int = 1, *,
                            kernel: str = "ring_round",
                            records: Iterable = ()) -> int:
    """Assert the fused-launch density of a ring round run on one device:
    exactly ``per_bucket`` launches of ``kernel`` per bucket, and no
    collective (the transport is inside the kernel). Returns the
    launches."""
    got = kernel_launches(launches)[kernel]
    want = int(n_buckets) * int(per_bucket)
    if got != want:
        raise AssertionError(
            f"{kernel} launches: got {got}, want {want} "
            f"({per_bucket}/bucket × {n_buckets} buckets)")
    colls = {k: v for k, v in collective_counts(records).items() if v}
    if colls:
        raise AssertionError(f"fused ring round made collectives: {colls}")
    return got
