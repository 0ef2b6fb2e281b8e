"""Channel registry and spec parser (port of
:mod:`repro.channels.registry`).

Specs are ``"<name>:k1=v1,k2=v2"`` strings, e.g. ``bernoulli:p=0.1``.
Only the Bernoulli channel is ported; the JAX package's other channel
families raise ``NotImplementedError``, and unknown names ``ValueError``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

from repro_torch.channels.base import Channel
from repro_torch.channels.bernoulli import BernoulliChannel

ChannelSpec = Union[None, str, Channel]

_REGISTRY = {"bernoulli": BernoulliChannel}
_ALIASES = {"iid": "bernoulli", "bern": "bernoulli"}
# the JAX package's other families (and their aliases), still to port
_NOT_PORTED = ("ge", "gilbert", "gilbert-elliott", "gilbert_elliott",
               "hetero", "pods", "heterogeneous", "deadline", "straggler",
               "trace", "netsim")


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
    """``"bernoulli:p=0.1,s=4"`` -> ``("bernoulli", {"p": 0.1, "s": 4})``."""
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


def make_channel(spec: ChannelSpec, n: int, default_p: float = 0.0,
                 s: Optional[int] = None) -> Channel:
    """Resolve a spec string, a built :class:`Channel` (returned as-is) or
    ``None`` (→ ``BernoulliChannel(n, default_p)``) for an n-worker
    exchange. For bernoulli an omitted ``p`` inherits ``default_p``."""
    if isinstance(spec, Channel):
        if spec.n != n:
            raise ValueError(f"channel built for n={spec.n}, need n={n}")
        if s is not None and spec.s != s:
            raise ValueError(f"channel built for s={spec.s}, need s={s}")
        return spec
    if spec is None or spec == "":
        return BernoulliChannel(n, default_p, s=s)
    name, kwargs = parse_spec(spec)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"channel {name!r} is not ported yet; ported: "
            f"{', '.join(channel_names())}")
    if name not in _REGISTRY:
        raise ValueError(f"unknown channel {name!r}; "
                         f"known: {', '.join(channel_names())}")
    kwargs.setdefault("p", default_p)
    if s is not None:
        if kwargs.get("s", s) != s:
            raise ValueError(f"spec {spec!r} sets s={kwargs['s']} but the "
                             f"harness is configured for s={s}")
        kwargs["s"] = s
    try:
        return _REGISTRY[name](n, **kwargs)
    except TypeError as e:
        raise ValueError(f"bad args for channel {name!r}: {e}") from e
