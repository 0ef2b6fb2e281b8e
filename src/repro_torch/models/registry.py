"""Top-level model API (port of :mod:`repro.models.registry`) for the
dense family (gemma3, deepseek, starcoder2, llama3; mixtral and kimi with
their MoE FFN), the ssm family (RWKV-6) and the hybrid family
(RecurrentGemma). The vlm and audio families are not ported yet.

``build_model(cfg, device=...)`` returns a :class:`Model` whose methods
work on plain parameter dicts:

  init(gen)                                   -> params
  init_stacked(gen)                           -> train-layout params
  loss(train-layout params, {"tokens", "labels": (B,S)})
                                              -> (loss, metrics)
  prefill(params, {"tokens": (B,S)}, max_len=None, paged=False)
                                              -> (last_logits, cache)
  decode_step(params, cache, {"token": (B,1)}, pos) -> (logits, cache)
  init_cache(batch_size, max_len)             -> cache
  decode_paged(params, pool, {"token": (B,1)}, pos, bt, page=...)
                                              -> (logits, pool)
  init_paged(n_slots)                         -> pool

Serving keeps one parameter dict per layer (``params["layers"]`` a list);
training keeps the JAX package's stacked layout (``params["layers"]`` a
dict of per-kind stacks, :func:`repro_torch.models.stack.stack_layers`),
so that the exchange's blocks fall where the reference's do. ``loss``
runs every ported family (rwkv and rec on the reference's XLA-route
recurrences); autograd gives its gradients.

The contiguous cache (``paged=False``, ``decode_step``, ``init_cache``)
serves every ported family (the dense kinds on the reference's
ring-buffer KV cache); the paged pool serves the dense kinds.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import stack as S
from repro_torch.models.hybrid import hybrid_kind_sequence
from repro_torch.models.transformer import dense_kind_sequence


def kind_sequence(cfg: ArchConfig) -> List[str]:
    """Per-layer kind names in faithful order."""
    if cfg.family == "dense":
        return dense_kind_sequence(cfg)
    if cfg.family == "ssm":
        return ["rwkv"] * cfg.n_layers
    if cfg.family == "hybrid":
        return hybrid_kind_sequence(cfg)
    raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                              f"ported yet")


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

    def init_stacked(self, gen: torch.Generator) -> dict:
        """Random parameters in the train path's stacked layout, drawn as
        :meth:`init` draws them."""
        params = self.init(gen)
        return {"embed": params["embed"],
                "layers": S.stack_layers(params["layers"], self.kinds)}

    def loss(self, params, batch):
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels": (B, S)}) under train-layout ``params``. Returns (nll +
        aux_loss, {"nll", "aux_loss"}); the aux loss is the MoE layers'
        load-balance term (0 without experts)."""
        x = L.embed(params["embed"], batch["tokens"])
        x, aux = S.apply_stack_train(params["layers"], x, self.cfg,
                                     self.kinds)
        logits = L.lm_head(params["embed"], x, self.cfg.vocab_size)
        nll = L.softmax_xent(logits, batch["labels"])
        return nll + aux, {"nll": nll, "aux_loss": aux}

    def prefill(self, params, inputs, max_len=None, paged: bool = False):
        """Prompt pass. Returns the last position's logits (B, vocab) and
        the per-layer cache: with ``paged`` the K/V of every position
        (dense kinds, for the slot pool), else the contiguous decode
        cache (dense: the last ``window`` K/V rows, or all rows padded to
        ``max_len`` for a global layer; rwkv: final state and token
        shifts; rec: conv state and f32 carry)."""
        x = L.embed(params["embed"], inputs["tokens"])
        x, cache = S.apply_stack(params["layers"], x, self.cfg, self.kinds,
                                 mode="prefill", paged=paged,
                                 max_len=max_len)
        vocab = self.cfg.vocab_size
        last = L.lm_head(params["embed"], x[:, -1:], vocab)[:, 0, :vocab]
        return last, cache

    def decode_step(self, params, cache, inputs, pos):
        """One decode step against the contiguous cache at ``pos`` (the
        new token's position, the same for every request). Returns
        (logits (B, vocab), new cache); the dense kinds' K/V caches are
        written in place (the reference donates them)."""
        x = L.embed(params["embed"], inputs["token"])
        x, cache = S.apply_stack(params["layers"], x, self.cfg, self.kinds,
                                 mode="decode", cache=cache, pos=pos)
        vocab = self.cfg.vocab_size
        logits = L.lm_head(params["embed"], x, vocab)[:, 0, :vocab]
        return logits, cache

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """Empty contiguous decode cache (``max_len`` as in
        :meth:`prefill`)."""
        return S.init_cache(self.cfg, self.kinds, batch_size, max_len,
                            self.device)

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
    """The model on ``device`` (CUDA unless the caller asks for the CPU;
    raises when CUDA is asked for and absent)."""
    return Model(cfg, kind_sequence(cfg), resolve_device(device))
