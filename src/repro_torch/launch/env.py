"""Host environment preamble (port of :mod:`repro.launch.env`).

Two pieces of host hygiene for the port's launchers, benches and their
subprocess tests:

  * the CPU thread count of torch's intra-op pool (``OMP_NUM_THREADS``,
    ``MKL_NUM_THREADS``), in place of the reference's XLA host device
    count: several torch processes on one host each start one thread per
    core by default, and their pools then oversubscribe the cores;
  * tcmalloc: ``LD_PRELOAD`` when the library is present, plus a
    large-alloc report threshold high enough to keep it quiet.

This module must stay importable *before* torch — the OpenMP pool reads
``OMP_NUM_THREADS`` when torch initialises it — so it imports nothing
heavy (the ``repro_torch`` package imports torch lazily for the same
reason). Two entry points:

  * :func:`apply` — in-process: merge the computed vars into
    ``os.environ`` (call before torch is imported; when it already is,
    ``torch.set_num_threads`` takes the count too). ``LD_PRELOAD``
    cannot take effect in-process and is left to the shell;
  * ``python -m repro_torch.launch.env [--threads N] -- <cmd …>`` —
    emit ``export K='V'`` lines for a shell to eval before exec'ing the
    command (this path does preload tcmalloc).

With no thread count asked for, nothing about threads is set and torch
keeps its own choice.
"""
from __future__ import annotations

import glob
import os
import sys
from typing import Dict, List, Optional, Sequence

# keep tcmalloc quiet about large, perfectly normal buffers (reports only
# above 60 GB)
TCMALLOC_REPORT_THRESHOLD = "60000000000"

THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS")

_TCMALLOC_GLOBS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc*.so*",
    "/usr/lib/aarch64-linux-gnu/libtcmalloc*.so*",
    "/usr/lib64/libtcmalloc*.so*",
    "/usr/lib/libtcmalloc*.so*",
    "/usr/local/lib/libtcmalloc*.so*",
)


def find_tcmalloc() -> Optional[str]:
    """Path of an installed tcmalloc shared library, or None; the
    minimal variant (no heap profiler hooks) first."""
    hits: List[str] = []
    for pat in _TCMALLOC_GLOBS:
        hits.extend(glob.glob(pat))
    if not hits:
        return None
    hits.sort(key=lambda p: ("minimal" not in p, len(p)))
    return hits[0]


def workers_from_argv(argv: Sequence[str]) -> Optional[int]:
    """The ``--workers N`` / ``--workers=N`` value from a command line, or
    None."""
    argv = list(argv)
    for i, a in enumerate(argv):
        if a == "--workers" and i + 1 < len(argv):
            try:
                return int(argv[i + 1])
            except ValueError:
                return None
        if a.startswith("--workers="):
            try:
                return int(a.split("=", 1)[1])
            except ValueError:
                return None
    return None


def host_env(threads: Optional[int] = None, tcmalloc: bool = True,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The host environment as a dict (pure — nothing is mutated).

    ``threads`` sets ``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` (None:
    left to torch). ``tcmalloc=True`` adds ``LD_PRELOAD``, merged into
    ``base``'s (default ``os.environ``) without duplicating the library,
    and the report threshold when the library exists — meaningful only
    when a shell exports the result before process start."""
    base = dict(os.environ if base is None else base)
    out: Dict[str, str] = {}
    if threads is not None:
        if int(threads) < 1:
            raise ValueError(f"need >= 1 threads, got {threads}")
        for var in THREAD_VARS:
            out[var] = str(int(threads))
    if tcmalloc:
        lib = find_tcmalloc()
        if lib is not None:
            pre = base.get("LD_PRELOAD", "")
            if lib not in pre.split(":"):
                out["LD_PRELOAD"] = f"{pre}:{lib}".strip(":")
            out["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = \
                TCMALLOC_REPORT_THRESHOLD
    return out


def apply(threads: Optional[int] = None) -> Dict[str, str]:
    """Merge the host vars into ``os.environ`` for this process (call
    before torch is imported; if it already is, its pool is resized with
    ``torch.set_num_threads``). ``LD_PRELOAD`` is skipped — the loader
    resolved symbols long ago. Returns what was set."""
    env = host_env(threads=threads, tcmalloc=False)
    os.environ.update(env)
    if threads is not None and "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(int(threads))
    return env


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="emit `export K=V` host preamble lines for a shell to "
                    "eval (everything after `--` is the command about to "
                    "run)")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's intra-op CPU threads (default: torch's "
                         "choice)")
    ap.add_argument("--no-tcmalloc", action="store_true")
    ap.add_argument("cmd", nargs="*", help="the command the shell will exec")
    args = ap.parse_args(argv)
    env = host_env(threads=args.threads, tcmalloc=not args.no_tcmalloc)
    for k, v in sorted(env.items()):
        sys.stdout.write(f"export {k}={v!r}\n")


if __name__ == "__main__":
    main()
