"""Input specs and random batches (port of :mod:`repro.models.inputs`).

``train_specs`` / ``decode_specs`` / ``input_specs`` give every model
input as a tensor on the meta device (the shape and dtype, no
allocation), the reference's ``ShapeDtypeStruct`` stand-ins;
``cache_specs`` builds the contiguous decode cache there. ``make_batch``
materialises a random batch matching ``train_specs`` from
``np.random.default_rng(seed)``, drawing the leaves in the reference's
order, so both packages make the same batch bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def train_specs(cfg: ArchConfig, B: int, S: int) -> Dict[str, torch.Tensor]:
    """The train / prefill inputs of a (B, S) batch: tokens and labels,
    with the vlm's (B, P, d) patches (then S − P tokens) or the audio
    model's (B, S // r, d) frames."""
    i32, dt = torch.int32, cfg.torch_dtype
    if cfg.family == "vlm":
        st = S - cfg.n_patches
        return {"tokens": _meta((B, st), i32),
                "patches": _meta((B, cfg.n_patches, cfg.d_model), dt),
                "labels": _meta((B, st), i32)}
    if cfg.family == "audio":
        return {"frames": _meta((B, S // cfg.enc_frames_ratio, cfg.d_model),
                                dt),
                "tokens": _meta((B, S), i32),
                "labels": _meta((B, S), i32)}
    return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}


def decode_specs(cfg: ArchConfig, B: int) -> Dict[str, torch.Tensor]:
    return {"token": _meta((B, 1), torch.int32)}


def input_specs(cfg: ArchConfig, shape: ShapeConfig | str
                ) -> Dict[str, torch.Tensor]:
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if shape.kind in ("train", "prefill"):
        return train_specs(cfg, shape.global_batch, shape.seq_len)
    return decode_specs(cfg, shape.global_batch)


def cache_specs(model, batch: int, max_len: int):
    """The contiguous decode cache of ``model`` on the meta device."""
    meta = dataclasses.replace(model, device=torch.device("meta"))
    return meta.init_cache(batch, max_len)


def float_leaf(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A float64 numpy draw as ``dtype``, rounded as the reference's
    ``jnp.asarray(a, dtype)`` rounds it: to f32 first (JAX without x64),
    then to ``dtype``."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(device=device,
                                                          dtype=dtype)


def make_batch(cfg: ArchConfig, B: int, S: int, seed: int = 0,
               device="cuda") -> Dict[str, torch.Tensor]:
    """A random batch matching :func:`train_specs`, on ``device``: the int
    leaves ``integers(0, vocab)``, the float leaves ``normal · 0.02`` in
    the config's dtype, drawn from ``default_rng(seed)`` in the specs'
    key order."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in train_specs(cfg, B, S).items():
        if s.dtype == torch.int32:
            out[k] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, size=s.shape).astype(
                    np.int32)).to(device)
        else:
            out[k] = float_leaf(rng.normal(size=s.shape) * 0.02, s.dtype,
                                device)
    return out
