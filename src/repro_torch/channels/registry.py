"""Channel registry and spec parser (port of
:mod:`repro.channels.registry`).

Benchmarks, examples and launchers select channels with compact specs,
``"<name>:k1=v1,k2=v2"``:

    bernoulli:p=0.1                     (aliases: iid, bern)
    ge:p_bad=0.3,burst=8                (aliases: gilbert, gilbert-elliott,
                                         gilbert_elliott)
    ge:p_bad=1.0,burst=8,p=0.1          (matched average rate 0.1)
    hetero:n_pods=4,p_intra=0.0,p_cross=0.3   (aliases: pods, heterogeneous)
    deadline:deadline_ms=8,straggler_frac=0.2   (alias: straggler)
    trace:path=colo.npz                 (or trace:lam=8000,prio=0.8 to run
                                         the netsim colocation sim inline;
                                         alias: netsim)

``make_channel(spec, n, default_p)`` is the single entry point: a spec
string, a built :class:`Channel` (returned as is), or ``None``
(``BernoulliChannel(n, default_p)``). For bernoulli an omitted ``p``
inherits ``default_p``. Unknown names raise ``ValueError`` listing the
registered ones. ``corruption=`` (a ``"kind:k=v"`` spec over
``bitflip``, ``scale``, ``signflip``, ``collude``, a built
:class:`Corruption`, or ``None``; :func:`make_corruption`) wraps the
channel in a :class:`CorruptionChannel`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

from repro_torch.channels import corruption as corruption_lib
from repro_torch.channels.base import Channel
from repro_torch.channels.bernoulli import BernoulliChannel
from repro_torch.channels.corruption import Corruption
from repro_torch.channels.deadline import DeadlineChannel
from repro_torch.channels.gilbert_elliott import GilbertElliottChannel
from repro_torch.channels.heterogeneous import HeterogeneousChannel
from repro_torch.channels.trace import TraceChannel

ChannelSpec = Union[None, str, Channel]
CorruptionSpec = Union[None, str, Corruption]

_REGISTRY: Dict[str, Callable[..., Channel]] = {}
_ALIASES: Dict[str, str] = {}


def register(name: str, builder: Callable[..., Channel],
             aliases: Tuple[str, ...] = ()) -> None:
    _REGISTRY[name] = builder
    for a in aliases:
        _ALIASES[a] = name


def channel_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _coerce(v: str):
    low = v.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def parse_spec(spec: str) -> Tuple[str, Dict[str, object]]:
    """``"ge:p_bad=0.3,burst=8"`` -> ``("ge", {"p_bad": 0.3, "burst": 8})``."""
    name, _, rest = spec.strip().partition(":")
    name = _ALIASES.get(name.lower(), name.lower())
    kwargs: Dict[str, object] = {}
    for item in filter(None, (s.strip() for s in rest.split(","))):
        k, eq, v = item.partition("=")
        if not eq:
            raise ValueError(f"malformed channel arg {item!r} in {spec!r} "
                             "(expected key=value)")
        kwargs[k.strip()] = _coerce(v)
    return name, kwargs


def corruption_names() -> Tuple[str, ...]:
    return tuple(corruption_lib.CORRUPTIONS)


def make_corruption(spec: CorruptionSpec,
                    byzantine_frac: Optional[float] = None
                    ) -> Optional[Corruption]:
    """A corruption process from a ``"kind:k=v,..."`` spec, a built
    :class:`Corruption` or ``None``. A separate ``byzantine_frac``
    overlays the spec's own; given alone (no spec) it selects the
    ``collude`` attack. ``None`` when nothing corrupts."""
    if isinstance(spec, Corruption):
        if byzantine_frac is not None:
            spec = dataclasses.replace(spec,
                                       byzantine_frac=float(byzantine_frac))
        return spec
    if spec is None or spec == "":
        if not byzantine_frac:
            return None
        return Corruption("collude", byzantine_frac=float(byzantine_frac))
    name, kwargs = parse_spec(spec)
    if name not in corruption_lib.CORRUPTIONS:
        raise ValueError(f"unknown corruption {name!r}; "
                         f"known: {', '.join(corruption_names())}")
    if byzantine_frac is not None:
        kwargs["byzantine_frac"] = float(byzantine_frac)
    try:
        return Corruption(name, **kwargs)
    except TypeError as e:
        raise ValueError(f"bad args for corruption {name!r}: {e}") from e


def make_channel(spec: ChannelSpec, n: int, default_p: float = 0.0,
                 s: Optional[int] = None,
                 corruption: CorruptionSpec = None) -> Channel:
    """Resolve a channel spec for an n-worker exchange (see the module
    doc). ``s`` is the number of server blocks (``None``: s = n); a spec
    may carry ``s=<int>``, which must agree with an explicit ``s``.
    ``corruption`` wraps the built channel (a process that corrupts
    nothing leaves it unwrapped)."""
    corr = make_corruption(corruption)
    if isinstance(spec, Channel):
        if spec.n != n:
            raise ValueError(f"channel built for n={spec.n}, need n={n}")
        if s is not None and spec.s != s:
            raise ValueError(f"channel built for s={spec.s}, need s={s}")
        return corruption_lib.wrap(spec, corr)
    if spec is None or spec == "":
        return corruption_lib.wrap(BernoulliChannel(n, default_p, s=s),
                                   corr)
    name, kwargs = parse_spec(spec)
    if name not in _REGISTRY:
        raise ValueError(f"unknown channel {name!r}; "
                         f"known: {', '.join(channel_names())}")
    if name == "bernoulli":
        kwargs.setdefault("p", default_p)
    if s is not None:
        if kwargs.get("s", s) != s:
            raise ValueError(f"spec {spec!r} sets s={kwargs['s']} but the "
                             f"harness is configured for s={s}")
        kwargs["s"] = s
    try:
        return corruption_lib.wrap(_REGISTRY[name](n, **kwargs), corr)
    except TypeError as e:
        raise ValueError(f"bad args for channel {name!r}: {e}") from e


def _build_hetero(n: int, n_pods: int = 2, p_intra: float = 0.0,
                  p_cross: float = 0.2,
                  s: Optional[int] = None) -> HeterogeneousChannel:
    return HeterogeneousChannel.pods(n, n_pods, p_intra, p_cross, s=s)


def _build_trace(n: int, path: Optional[str] = None,
                 lam: float = 8000.0, prio: float = 0.8,
                 s: Optional[int] = None) -> TraceChannel:
    if path is not None:
        return TraceChannel.from_npz(n, str(path), s=s)
    return TraceChannel.from_netsim(n, lam, prio, s=s)


register("bernoulli", BernoulliChannel, aliases=("iid", "bern"))
register("ge", GilbertElliottChannel,
         aliases=("gilbert", "gilbert-elliott", "gilbert_elliott"))
register("hetero", _build_hetero, aliases=("pods", "heterogeneous"))
register("deadline", DeadlineChannel, aliases=("straggler",))
register("trace", _build_trace, aliases=("netsim",))
