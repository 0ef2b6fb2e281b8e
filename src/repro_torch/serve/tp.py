"""Drop-masked tensor-parallel decode (port of :mod:`repro.serve.tp`).

Tensor parallelism splits every output projection (attention ``wo`` over
heads, MLP ``wo`` over the hidden dim) across ``n`` workers; each worker
holds a partial sum of the layer output and the layer ends in an
all-reduce. On a lossy interconnect that all-reduce is the paper's
exchange with activations as the payload: feeding ``n · partial_i`` as
worker i's "model" into the RS+AG round, the renormalised block average
gives

    out_j  =  (n / |delivered_j|) · Σ_{i ∈ delivered_j} partial_i

per server block j, while a worker that misses block j's broadcast keeps
its own ``n · partial_i`` (model-mode AG). The activation is transposed to
``(d_model, batch)`` so the decode plan's server blocks slice the model
dim. Each layer has two collective sites (attention, MLP): ``2·layer``
and ``2·layer + 1``; the engine draws one ``(2·L, n, s)`` mask stack per
decode step.

As in the JAX package, the plan is built for f32, so the combine returns
f32 and the residual stream of a bf16 model turns f32 at the first
combine. With no channel and p = 0 the engine passes ``tp=None`` and the
dense path runs untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.channels.registry import make_channel
from repro_torch.core import plan as plan_lib
from repro_torch.core import rps as rps_lib
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class TPDecodeConfig:
    """CLI-facing knobs for the drop-masked TP decode path."""
    n_shards: int = 4
    p: float = 0.0
    channel: Optional[str] = None        # channels.registry spec string
    s: Optional[int] = None              # server blocks (default n_shards)
    wire: str = "f32"                    # RS-leg codec
    recovery: str = "renorm"             # renorm (Alg. 1) / scale
    engine: str = "xla"                  # global-view lowering
    receiver: int = 0                    # worker whose consensus is served

    @property
    def active(self) -> bool:
        """False is the structural p = 0 gate: no exchange is built."""
        return self.channel is not None or self.p > 0.0


class TPContext:
    """Per-engine TP state: the activation plan for the static
    (d_model, batch) decode shape and the combines the layers call."""

    def __init__(self, cfg: TPDecodeConfig, *, d_model: int, batch: int,
                 n_heads: int, d_ff: int, n_layers: int):
        n = int(cfg.n_shards)
        if n < 2:
            raise ValueError(f"n_shards={n} must be >= 2")
        if n_heads % n or d_ff % n:
            raise ValueError(
                f"n_shards={n} must divide n_heads={n_heads} and "
                f"d_ff={d_ff} (head- and hidden-dim sharding)")
        if cfg.recovery not in ("renorm", "scale"):
            raise ValueError(
                f"recovery={cfg.recovery!r}: decode activations are "
                f"stateless; use 'renorm' or 'scale'")
        self.cfg = cfg
        self.n = n
        self.n_sites = 2 * int(n_layers)
        self.channel = make_channel(
            cfg.channel if cfg.channel is not None else "bernoulli", n,
            cfg.p, s=cfg.s)
        self.p_eff = float(self.channel.effective_p())
        self.plan = plan_lib.decode_plan(
            d_model, batch, n, cfg.s, wire=cfg.wire, recovery=cfg.recovery,
            engine=cfg.engine)
        self.receiver = int(cfg.receiver)
        if not 0 <= self.receiver < n:
            raise ValueError(f"receiver={cfg.receiver} not in [0, {n})")

    # -- mask sampling (once per decode step) -------------------------------

    def init_state(self, gen: torch.Generator):
        return self.channel.init_state(gen)

    def sample_site_masks(self, gen: torch.Generator, state):
        """(rs, ag) stacks of shape (n_sites, n, s) + the channel state —
        one fate per collective site of this decode step."""
        rs, ag, state = self.channel.sample_packets(gen, state, self.n_sites)
        return (rs, ag), state

    # -- combines (called by the model layers) ------------------------------

    def _exchange(self, partials, masks, site):
        """partials: (n, B, 1, d) -> the receiver's consensus (B, 1, d)."""
        rs, ag = masks[0][site], masks[1][site]
        n = self.n
        # n·partial_i as worker i's model copy; transpose so the plan's
        # flat blocks slice the d dim
        y = torch.permute(partials[:, :, 0, :] * n, (0, 2, 1))   # (n, d, B)
        out = rps_lib.rps_exchange_global(
            y, None, self.p_eff, n, mode="model", masks=(rs, ag),
            plan=self.plan, engine=self.cfg.engine)
        return out[self.receiver].transpose(0, 1)[:, None, :]

    def combine_attn(self, out, wo, masks, site):
        """Sharded attention output projection: heads split n ways, each
        shard's slice of the contraction is its partial sum.
        out: (B, 1, h, hd), wo: (h, hd, d) -> (B, 1, d)."""
        B, S, h, hd = out.shape
        g = h // self.n
        parts = L.einsum("bsnge,nged->nbsd",
                         out.reshape(B, S, self.n, g, hd),
                         wo.reshape(self.n, g, hd, wo.shape[-1]))
        return self._exchange(parts, masks, site)

    def combine_mlp(self, p_mlp, x, masks, site):
        """Sharded gated MLP: the hidden dim splits n ways; each shard
        contributes a partial of the output contraction.
        x: (B, 1, d) normed input -> (B, 1, d)."""
        h = L.mlp_hidden(p_mlp, x)
        B, S, ff = h.shape
        f = ff // self.n
        parts = L.einsum("bsnf,nfd->nbsd", h.reshape(B, S, self.n, f),
                         p_mlp["wo"].reshape(self.n, f,
                                             p_mlp["wo"].shape[-1]))
        return self._exchange(parts, masks, site)


def make_tp_context(cfg: Optional[TPDecodeConfig], model_cfg,
                    batch: int) -> Optional[TPContext]:
    """None (the structural dense gate) unless the config asks for a lossy
    wire — p > 0 or an explicit channel spec."""
    if cfg is None or not cfg.active:
        return None
    return TPContext(cfg, d_model=model_cfg.d_model, batch=batch,
                     n_heads=model_cfg.n_heads, d_ff=model_cfg.d_ff,
                     n_layers=model_cfg.n_layers)
