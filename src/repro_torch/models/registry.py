"""Top-level model API (port of :mod:`repro.models.registry`) for every
family: dense (gemma3, deepseek, starcoder2, llama3; mixtral and kimi
with their MoE FFN), ssm (RWKV-6), hybrid (RecurrentGemma), audio
(Whisper: an encoder stack and cross-attention decoder layers) and vlm
(LLaVA-NeXT: the dense Mistral backbone with patch embeddings before the
tokens).

``build_model(cfg, device=...)`` returns a :class:`Model` whose methods
work on plain parameter dicts:

  init(gen)                                   -> params
  init_stacked(gen)                           -> train-layout params
  loss(train-layout params, batch)            -> (loss, metrics)
  prefill(params, inputs, max_len=None, paged=False[, tp, fsdp, rows])
                                              -> (last_logits, cache)
  decode_step(params, cache, {"token": (B,1)}, pos[, tp, fsdp, rows])
                                              -> (logits, cache)
  init_cache(batch_size, max_len[, tp])       -> cache
  decode_paged(params, pool, {"token": (B,1)}, pos, bt, page=...)
                                              -> (logits, pool)
  init_paged(n_slots)                         -> pool

Batch and prompt layouts (:mod:`repro_torch.models.inputs`):

  dense / ssm / hybrid: {tokens: (B,S), labels: (B,S)}
  vlm:   {tokens: (B,S-P), patches: (B,P,d), labels: (B,S-P)}
  audio: {frames: (B,S//r,d), tokens: (B,S), labels: (B,S)}

(prefill's inputs drop the labels). The vlm's prefill writes the
``n_patches`` patch rows and then the prompt's rows, so its first decode
position is the prompt's length plus :attr:`Model.prefix_len`; the audio
model's frames are not in the decoder's sequence, and its decode reads
the cross K/V from the cache.

Serving keeps one parameter dict per layer (``params["layers"]`` a list,
and the audio model's ``params["enc_layers"]``); training keeps the JAX
package's stacked layout (``params["layers"]`` a dict of per-kind
stacks, ``params["enc_layers"]`` = {"enc": stack},
:func:`repro_torch.models.stack.stack_layers`), so that the exchange's
blocks fall where the reference's do. ``loss`` runs every family (rwkv
and rec on the reference's XLA-route recurrences), on a replica's
shards too (``tp``, ``fsdp``); autograd gives its gradients.

The contiguous cache (``paged=False``, ``decode_step``, ``init_cache``)
serves every family (the dense kinds on the reference's ring-buffer KV
cache), on a mesh too (``tp``, ``fsdp``, ``rows``; ``serve/mesh.py``);
the paged pool serves the dense kinds (not the vlm and audio
families: the reference has no continuous path for them).
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import parallel as P
from repro_torch.models import stack as S
from repro_torch.models.hybrid import hybrid_kind_sequence
from repro_torch.models.transformer import dense_kind_sequence


def kind_sequence(cfg: ArchConfig) -> List[str]:
    """Per-layer decoder kind names in faithful order."""
    if cfg.family in ("dense", "vlm"):
        return dense_kind_sequence(cfg)
    if cfg.family == "ssm":
        return ["rwkv"] * cfg.n_layers
    if cfg.family == "hybrid":
        return hybrid_kind_sequence(cfg)
    if cfg.family == "audio":
        return ["xattn"] * cfg.n_layers
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def enc_kind_sequence(cfg: ArchConfig) -> List[str]:
    """The encoder stack's kinds (the audio family's; empty otherwise)."""
    return ["enc"] * cfg.enc_layers if cfg.family == "audio" else []


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    kinds: List[str]                      # decoder kind sequence
    device: torch.device
    enc_kinds: List[str] = dataclasses.field(default_factory=list)

    @property
    def prefix_len(self) -> int:
        """The rows that stand before the tokens in the decoder's
        sequence: the vlm's ``n_patches`` patch embeddings (0 in every
        other family's config). Prefill writes them, so decoding starts at
        the prompt's length plus this."""
        return self.cfg.n_patches

    def init(self, gen: torch.Generator) -> dict:
        """Random parameters at the JAX package's scales, drawn from
        ``gen`` (which must live on the model's device)."""
        if gen.device.type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on "
                             f"{self.device}")
        params = {"embed": L.init_embed(gen, self.cfg),
                  "layers": S.init_stack(gen, self.cfg, self.kinds)}
        if self.enc_kinds:
            params["enc_layers"] = S.init_stack(gen, self.cfg,
                                                self.enc_kinds)
        return params

    def init_stacked(self, gen: torch.Generator) -> dict:
        """Random parameters in the train path's stacked layout, drawn as
        :meth:`init` draws them."""
        params = self.init(gen)
        out = {"embed": params["embed"],
               "layers": S.stack_layers(params["layers"], self.kinds)}
        if self.enc_kinds:
            out["enc_layers"] = S.stack_layers(params["enc_layers"],
                                               self.enc_kinds)
        return out

    def encode(self, params, frames: torch.Tensor, fsdp=None,
               tp=None) -> torch.Tensor:
        """The audio encoder over ``frames`` (B, S_src, d), cast to the
        config's dtype, in train mode (both layouts): its output
        (B, S_src, d). ``fsdp`` and ``tp`` as in :meth:`loss` (the
        train layout) or :meth:`prefill` (the serving layout); the output
        whole and alike on every rank of the model group."""
        x = frames.to(self.cfg.torch_dtype)
        enc = params["enc_layers"]
        fsdp = None if fsdp is None else fsdp.at("enc_layers")
        if isinstance(enc, dict):
            return S.apply_stack_train(enc, x, self.cfg, self.enc_kinds,
                                       tp=tp, fsdp=fsdp)[0]
        return S.apply_stack(enc, x, self.cfg, self.enc_kinds,
                             mode="prefill", tp=tp, fsdp=fsdp)[0]

    def _aux(self, params, inputs, fsdp=None, tp=None) -> dict:
        if self.cfg.family != "audio":
            return {}
        return {"enc_out": self.encode(params, inputs["frames"], fsdp, tp)}

    def embed_inputs(self, params, inputs, tp=None) -> torch.Tensor:
        """The token embeddings, after the vlm's patch embeddings (cast to
        the embedding's dtype); ``tp`` the vocab-parallel lookup."""
        tok = L.embed(params["embed"], inputs["tokens"], tp)
        if self.cfg.family == "vlm":
            return torch.cat([inputs["patches"].to(tok.dtype), tok], dim=1)
        return tok

    def loss(self, params, batch, tp=None, fsdp=None, rows=None):
        """Mean next-token cross-entropy of ``batch`` under train-layout
        ``params`` (the vlm's patch rows dropped before the head). Returns
        (nll + aux_loss, {"nll", "aux_loss"}); the aux loss is the MoE
        layers' load-balance term (0 without experts). ``tp``
        (:class:`repro_torch.models.parallel.TP`, every family) takes
        this rank's shards of a replica split over a "model" axis: the
        loss is the same scalar on every rank of the model group. ``fsdp`` (:class:`repro_torch.models.parallel.FSDP`,
        every family) takes this rank's FSDP shards, gathered layer by
        layer (``models/stack.py``). ``rows`` (a
        :class:`repro_torch.core.comm.Group`): ``batch`` is this rank's
        share of a batch whose rows are split over the group (the MoE's
        batch statistics span it)."""
        if tp is not None:
            P.check_family(self.cfg, tp.size)
        params = _gather_embed(params, fsdp)
        x = self.embed_inputs(params, batch, tp)
        x, aux = S.apply_stack_train(
            params["layers"], x, self.cfg, self.kinds,
            aux=self._aux(params, batch, fsdp, tp), tp=tp,
            fsdp=None if fsdp is None else fsdp.at("layers"), rows=rows)
        x = x[:, self.prefix_len:]
        logits = L.lm_head(params["embed"], x, self.cfg.vocab_size, tp)
        nll = L.softmax_xent(logits, batch["labels"], tp=tp)
        return nll + aux, {"nll": nll, "aux_loss": aux}

    def _check_mesh(self, tp) -> None:
        """Raise where the layout splits what a rank must hold whole
        (:func:`repro_torch.models.parallel.check_family`: an RWKV-6
        head); every family serves on a mesh."""
        if tp is not None:
            P.check_family(self.cfg, tp.size)

    def prefill(self, params, inputs, max_len=None, paged: bool = False,
                tp=None, fsdp=None, rows=None):
        """Prompt pass over ``inputs`` ({"tokens"}, with the vlm's
        "patches" or the audio model's "frames"). Returns the last
        position's logits (B, vocab) and the per-layer cache: with
        ``paged`` the K/V of every position (dense kinds, for the slot
        pool), else the contiguous decode cache (dense: the last
        ``window`` K/V rows, or all rows padded to ``max_len`` for a
        global layer; xattn: that and the cross K/V; rwkv: final state
        and token shifts; rec: conv state and f32 carry).

        On a mesh (every family; ``serve/mesh.py`` builds the
        contexts): ``tp`` (:class:`repro_torch.models.parallel.TP`) runs
        this rank's shards of a replica split over a "model" axis (the
        audio model's encoder too), its cache the KV heads its query
        heads read, rwkv's state its heads, rec's states its dr channels,
        the logits whole on every rank of the model group; ``fsdp``
        (:class:`repro_torch.models.parallel.FSDP`, its dims those of
        ``params`` with a leading layer dim of 1 a layer's leaf) gathers
        each layer's shards over the data group for the layer; ``rows``
        (a :class:`repro_torch.core.comm.Group`): ``inputs`` is this
        rank's share of a batch whose rows are split over the group (the
        MoE's batch statistics span it). ``tp=None`` and ``fsdp=None``
        is the one-device pass."""
        self._check_mesh(tp)
        params = _gather_embed(params, fsdp)
        x = self.embed_inputs(params, inputs, tp)
        x, cache = S.apply_stack(params["layers"], x, self.cfg, self.kinds,
                                 mode="prefill", paged=paged,
                                 max_len=max_len,
                                 aux=self._aux(params, inputs, fsdp, tp),
                                 tp=tp,
                                 fsdp=None if fsdp is None
                                 else fsdp.at("layers"), rows=rows)
        vocab = self.cfg.vocab_size
        last = L.lm_head_whole(params["embed"], x[:, -1:], vocab,
                               tp)[:, 0, :vocab]
        return last, cache

    def decode_step(self, params, cache, inputs, pos, tp=None, fsdp=None,
                    rows=None):
        """One decode step against the contiguous cache at ``pos`` (the
        new token's position, the same for every request). Returns
        (logits (B, vocab), new cache); the K/V caches are written in
        place (the reference donates them). The audio model's cross K/V
        come from the cache. ``tp``, ``fsdp`` and ``rows`` as in
        :meth:`prefill`."""
        self._check_mesh(tp)
        params = _gather_embed(params, fsdp)
        x = L.embed(params["embed"], inputs["token"], tp)
        x, cache = S.apply_stack(params["layers"], x, self.cfg, self.kinds,
                                 mode="decode", cache=cache, pos=pos, tp=tp,
                                 fsdp=None if fsdp is None
                                 else fsdp.at("layers"), rows=rows)
        vocab = self.cfg.vocab_size
        logits = L.lm_head_whole(params["embed"], x, vocab, tp)[:, 0, :vocab]
        return logits, cache

    def init_cache(self, batch_size: int, max_len: int, tp=None) -> list:
        """Empty contiguous decode cache of ``batch_size`` rows (a rank's
        rows on a mesh) (``max_len`` as in :meth:`prefill`; ``tp``: this
        rank's share, as its prefill leaves it)."""
        self._check_mesh(tp)
        return S.init_cache(self.cfg, self.kinds, batch_size, max_len,
                            self.device, tp)

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


def _gather_embed(params, fsdp):
    """``params`` with the FSDP shards of the leaves outside the stacks
    gathered for the whole step (none under the reference's rules)."""
    if fsdp is None or fsdp.sub("embed") is None:
        return params
    return dict(params, embed=fsdp.gather(params["embed"],
                                          fsdp.dims["embed"]))


def build_model(cfg: ArchConfig, *, device="cuda") -> Model:
    """The model on ``device`` (CUDA unless the caller asks for the CPU;
    raises when CUDA is asked for and absent)."""
    return Model(cfg, kind_sequence(cfg), resolve_device(device),
                 enc_kind_sequence(cfg))
