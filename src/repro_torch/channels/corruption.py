"""Corruption processes: packets that arrive wrong (port of
:mod:`repro.channels.corruption`).

The drop channels model erasures. A :class:`Corruption` process adds the
second axis: it samples a per-(worker, block) corruption mask beside the
drop masks and defines the transform an adversarial sender applies to its
offered contribution. :class:`CorruptionChannel` wraps any drop channel so
the two travel as one object; the exchange applies the transform on the
sender's side, before the codec, and never to the honest local copy (the
all-gather fallback).

Kinds:

  ``bitflip``   one uniformly random bit of each corrupted f32 value is
                XOR-flipped; non-finite results are clamped to ±FLT_MAX;
  ``scale``     the value arrives multiplied by ``gamma``;
  ``signflip``  the value arrives negated;
  ``collude``   the colluding-worker attack, −gamma·x.

Each non-owner (i, j) link corrupts independently with probability
``frac``, and the ⌊byzantine_frac·n⌋ lowest worker ids (the colluders)
corrupt every packet they send. Owner entries are never corrupted.
``frac = 0, byzantine_frac = 0`` corrupts nothing, and :func:`wrap` leaves
such a channel unwrapped.

Torch cannot reproduce JAX's threefry stream, so sampling is split as the
channels split it: :meth:`Corruption.draw` takes the uniforms from a
``torch.Generator`` and :meth:`Corruption.from_draws` is pure; the bitflip
transform takes its bit positions as ``bits=`` (drawn from a generator
when none are given), so the tests can hand in the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.channels import base
from repro_torch.core import rps as rps_lib

CORRUPTIONS = ("bitflip", "scale", "signflip", "collude")

_FLT_MAX = 3.4028235e38


def _shape(n: int, s: int, n_buckets: Optional[int]) -> Tuple[int, ...]:
    return (n, s) if n_buckets is None else (int(n_buckets), n, s)


def random_bits(gen: torch.Generator, shape: Tuple[int, ...]
                ) -> torch.Tensor:
    """Uniform bit positions 0..31 (int32) from ``gen``, on its device."""
    return torch.randint(0, 32, shape, generator=gen, dtype=torch.int32,
                         device=gen.device)


@dataclasses.dataclass(frozen=True)
class Corruption:
    """A corruption process: mask sampler and sender transform.

    ``frac``: i.i.d. per-(worker, block, round[, bucket]) corruption
    probability; ``byzantine_frac``: the fraction of workers that corrupt
    every packet (the lowest ids); ``gamma``: the magnitude of the scale
    and collude transforms."""
    kind: str = "signflip"
    frac: float = 0.0
    byzantine_frac: float = 0.0
    gamma: float = 10.0

    def __post_init__(self):
        if self.kind not in CORRUPTIONS:
            raise ValueError(f"corruption={self.kind!r}, want one of "
                             f"{CORRUPTIONS}")
        if not 0.0 <= float(self.frac) <= 1.0:
            raise ValueError(f"corruption frac={self.frac} not in [0,1]")
        if not 0.0 <= float(self.byzantine_frac) < 1.0:
            raise ValueError(f"byzantine_frac={self.byzantine_frac} "
                             "not in [0, 1)")

    def n_colluders(self, n: int) -> int:
        return int(self.byzantine_frac * n + 1e-9)

    def expected_frac(self, n: int) -> float:
        """Expected corrupted fraction of the non-owner links: the
        colluders corrupt everything, the rest ``frac`` of theirs."""
        b = self.n_colluders(n) / max(n, 1)
        return b + (1.0 - b) * float(self.frac)

    def draw(self, gen: torch.Generator, n: int, s: int,
             n_buckets: Optional[int] = None) -> Optional[torch.Tensor]:
        """The uniforms of one round's i.i.d. part (None when
        ``frac == 0``: the mask is then deterministic)."""
        if self.frac <= 0.0:
            return None
        return base.uniforms(gen, _shape(n, s, n_buckets))

    def from_draws(self, u: Optional[torch.Tensor], n: int, s: int,
                   n_buckets: Optional[int] = None,
                   device="cpu") -> torch.Tensor:
        """Bool corruption mask, ``(n, s)`` or ``(n_buckets, n, s)`` (the
        drop masks' layout, True = arrives wrong), from :meth:`draw`'s
        uniforms: ``u < frac`` (f32), the colluders' rows, owners off."""
        shape = _shape(n, s, n_buckets)
        if u is not None:
            device = u.device
            m = u < base.f32(self.frac, u)
        else:
            m = torch.zeros(shape, dtype=torch.bool, device=device)
        f = self.n_colluders(n)
        if f > 0:
            m = m | (torch.arange(n, device=device) < f)[:, None]
        return m & ~rps_lib.owner_mask(n, s, device=device)

    def sample(self, gen: torch.Generator, n: int, s: int,
               n_buckets: Optional[int] = None) -> torch.Tensor:
        return self.from_draws(self.draw(gen, n, s, n_buckets), n, s,
                               n_buckets, device=gen.device)

    def apply(self, x: torch.Tensor, cmask: torch.Tensor,
              bits: Optional[torch.Tensor] = None,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """The sender transform ``where(cmask, t(x), x)``, ``cmask``
        broadcastable to ``x``. The bitflip kind XORs ``1 << bits`` (an
        integer tensor of x's shape, values 0..31; drawn from ``gen`` when
        None) into the f32 view; the deterministic kinds ignore it."""
        if self.kind != "bitflip":
            factor = {"signflip": -1.0, "scale": float(self.gamma),
                      "collude": -float(self.gamma)}[self.kind]
            # t(x) = factor·x where corrupted, 1·x (exact) elsewhere: one
            # output and no same-size temporary
            one = torch.ones((), dtype=x.dtype, device=x.device)
            f = torch.where(cmask, torch.tensor(factor, dtype=x.dtype,
                                                device=x.device), one)
            return x * f
        if bits is None:
            if gen is None:
                gen = torch.Generator(device=x.device).manual_seed(0)
            bits = random_bits(gen, tuple(x.shape))
        bits = bits.to(device=x.device, dtype=torch.int32)
        one = torch.ones((), dtype=torch.int32, device=x.device)
        flipped = (x.to(torch.float32).view(torch.int32)
                   ^ torch.bitwise_left_shift(one, bits)).view(torch.float32)
        big = torch.copysign(
            torch.tensor(_FLT_MAX, dtype=torch.float32, device=x.device),
            flipped)
        flipped = torch.where(torch.isfinite(flipped), flipped, big)
        return torch.where(cmask, flipped.to(x.dtype), x)

    @property
    def spec(self) -> str:
        d = Corruption(self.kind)
        args = [f"{f_}={getattr(self, f_):g}"
                for f_ in ("frac", "byzantine_frac", "gamma")
                if getattr(self, f_) != getattr(d, f_)]
        return self.kind if not args else f"{self.kind}:{','.join(args)}"


class CorruptionChannel(base.Channel):
    """A drop channel wrapped with a :class:`Corruption` process. Every
    delivery draw (sync, per-packet and async), the state, ``effective_p``
    and the per-leg link expectations are the inner channel's: wrapping
    changes what arrives wrong, never what arrives. The process is
    ``.corruption``, sampled by :meth:`sample_corruption`."""

    def __init__(self, inner: base.Channel, corruption: Corruption):
        super().__init__(inner.n, inner.s)
        self.inner = inner
        self.corruption = corruption

    # ---- delivery: delegation -------------------------------------------
    def init_state(self, gen=None):
        return self.inner.init_state(gen)

    def draw(self, gen, lead=()):
        return self.inner.draw(gen, lead)

    def from_draws(self, draws, state=None):
        return self.inner.from_draws(draws, state)

    def sample(self, gen, state=None):
        return self.inner.sample(gen, state)

    def sample_packets(self, gen, state=None, n_buckets=1):
        return self.inner.sample_packets(gen, state, n_buckets)

    def sample_async(self, gen, state, slack_ms):
        return self.inner.sample_async(gen, state, slack_ms)

    def effective_p(self) -> float:
        return self.inner.effective_p()

    def expected_link_p(self):
        return self.inner.expected_link_p()

    def expected_link_p_ag(self):
        return self.inner.expected_link_p_ag()

    # ---- the corruption axis ----------------------------------------------
    def sample_corruption(self, gen: torch.Generator,
                          n_buckets: Optional[int] = None) -> torch.Tensor:
        return self.corruption.sample(gen, self.n, self.s,
                                      n_buckets=n_buckets)

    def __getattr__(self, name: str) -> Any:
        # the family's extras (deadline_ms, ...); reached only when the
        # normal lookup fails
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __repr__(self) -> str:
        return (f"CorruptionChannel({self.inner!r}, "
                f"{self.corruption.spec!r})")


def wrap(inner: base.Channel,
         corruption: Optional[Corruption]) -> base.Channel:
    """``inner`` wrapped, unless nothing corrupts (None, or frac = 0 with
    no colluders: that channel stays unwrapped)."""
    if corruption is None:
        return inner
    if corruption.frac == 0.0 and corruption.byzantine_frac == 0.0:
        return inner
    return CorruptionChannel(inner, corruption)
