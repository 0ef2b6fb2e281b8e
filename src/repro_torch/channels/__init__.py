"""Channel models for the RPS drop process (port of :mod:`repro.channels`;
Bernoulli only so far)."""
from repro_torch.channels.base import Channel, force_diag  # noqa: F401
from repro_torch.channels.bernoulli import BernoulliChannel  # noqa: F401
from repro_torch.channels.registry import (  # noqa: F401
    channel_names, make_channel, parse_spec)
