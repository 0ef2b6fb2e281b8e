"""Channel models for the RPS drop process (port of
:mod:`repro.channels`): i.i.d. Bernoulli, bursty Gilbert–Elliott,
per-link heterogeneous, deadline/straggler-induced, and a replayed
``netsim`` trace, and the corruption processes that wrap them.
``make_channel`` resolves spec strings like ``"ge:p_bad=0.3,burst=8"``,
``make_corruption`` ones like ``"collude:gamma=10"``."""
from repro_torch.channels.base import Channel, force_diag  # noqa: F401
from repro_torch.channels.bernoulli import BernoulliChannel  # noqa: F401
from repro_torch.channels.corruption import (  # noqa: F401
    CORRUPTIONS, Corruption, CorruptionChannel)
from repro_torch.channels.deadline import DeadlineChannel  # noqa: F401
from repro_torch.channels.gilbert_elliott import (  # noqa: F401
    GilbertElliottChannel)
from repro_torch.channels.heterogeneous import (  # noqa: F401
    HeterogeneousChannel)
from repro_torch.channels.registry import (  # noqa: F401
    ChannelSpec, CorruptionSpec, channel_names, corruption_names,
    make_channel, make_corruption, parse_spec, register)
from repro_torch.channels.trace import (  # noqa: F401
    TraceChannel, load_trace, save_trace)
