"""Top-level model API (port of :mod:`repro.models.registry`), dense
family only.

``build_model(cfg, device=...)`` returns a :class:`Model` whose methods
work on plain parameter dicts:

  init(gen)                                   -> params
  prefill(params, {"tokens": (B,S)}, paged=True) -> (last_logits, cache)
  decode_paged(params, pool, {"token": (B,1)}, pos, bt, page=...)
                                              -> (logits, pool)
  init_paged(n_slots)                         -> pool
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import stack as S
from repro_torch.models.transformer import dense_kind_sequence


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    kinds: List[str]                      # decoder kind sequence
    device: torch.device

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters at the JAX package's scales, drawn from
        ``gen`` (which must live on the model's device)."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        return {"embed": L.init_embed(gen, self.cfg),
                "layers": S.init_stack(gen, self.cfg, self.kinds)}

    def prefill(self, params, inputs, paged: bool = True):
        """Prompt pass. Returns the last position's logits (B, vocab) and
        the per-layer K/V of every position (the paged prefill)."""
        if not paged:
            raise NotImplementedError("the contiguous-cache prefill is not "
                                      "ported yet; use paged=True")
        x = L.embed(params["embed"], inputs["tokens"])
        x, cache = S.apply_stack(params["layers"], x, self.cfg, self.kinds,
                                 mode="prefill")
        vocab = self.cfg.vocab_size
        last = L.lm_head(params["embed"], x[:, -1:], vocab)[:, 0, :vocab]
        return last, cache

    def decode_paged(self, params, pool, inputs, pos, bt, *, page: int,
                     masks=None, tp=None):
        """One decode step against the paged slot pool.

        pos: (B,) per-request positions; bt: (B, P) block table. ``tp``
        (a ``serve.tp.TPContext``) with ``masks`` ((2·L, n, s) rs/ag
        stacks) sends every output projection through the drop-masked
        exchange; ``tp=None`` is the dense path.
        """
        x = L.embed(params["embed"], inputs["token"])
        paged = {"bt": bt, "page": page, "masks": masks, "tp": tp}
        x, pool = S.apply_stack(params["layers"], x, self.cfg, self.kinds,
                                mode="decode_paged", cache=pool, pos=pos,
                                paged=paged)
        vocab = self.cfg.vocab_size
        logits = L.lm_head(params["embed"], x, vocab)[:, 0, :vocab]
        return logits, pool

    def init_paged(self, n_slots: int) -> list:
        return S.init_paged(self.cfg, self.kinds, n_slots, self.device)


def build_model(cfg: ArchConfig, *, device="cuda") -> Model:
    """The dense model on ``device`` (CUDA unless the caller asks for the
    CPU; raises when CUDA is asked for and absent)."""
    if cfg.family != "dense" or cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} "
                                  f"(moe={cfg.is_moe}) is not ported yet")
    return Model(cfg, dense_kind_sequence(cfg), resolve_device(device))
