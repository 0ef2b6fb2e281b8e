"""Builds and loads the port's CUDA kernels from the sources in ``csrc/``.

``load_kernels()`` compiles every kernel source in one
``torch.utils.cpp_extension.load`` call for Hopper (``sm_90a``) into
``_build/`` beside this file (listed in ``.gitignore``) and returns the
``torch.ops.repro_torch`` namespace. It runs at first use, never at
import, so the CPU tests import every module without ``nvcc``. A build or
load failure raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import functools
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("masked_avg.cu", "rwkv6.cu", "rglru.cu", "ring.cu", "ring_q.cu",
           "binding.cpp")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")


@functools.cache
def load_kernels():
    """Compile (or reuse the build in ``_build/``) and load the kernels;
    returns ``torch.ops.repro_torch``."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    load(name="repro_torch_kernels",
         sources=[str(CSRC / s) for s in SOURCES],
         build_directory=str(BUILD_DIR),
         extra_cflags=["-O2"],
         extra_cuda_cflags=list(CUDA_FLAGS),
         extra_include_paths=[str(CSRC)],
         is_python_module=False,
         verbose=False)
    return torch.ops.repro_torch
