"""Channel models for the RPS drop process (port of
:mod:`repro.channels`): i.i.d. Bernoulli, bursty Gilbert–Elliott,
per-link heterogeneous, deadline/straggler-induced, and a replayed
``netsim`` trace. ``make_channel`` resolves spec strings like
``"ge:p_bad=0.3,burst=8"``. The corruption processes are not ported
yet."""
from repro_torch.channels.base import Channel, force_diag  # noqa: F401
from repro_torch.channels.bernoulli import BernoulliChannel  # noqa: F401
from repro_torch.channels.deadline import DeadlineChannel  # noqa: F401
from repro_torch.channels.gilbert_elliott import (  # noqa: F401
    GilbertElliottChannel)
from repro_torch.channels.heterogeneous import (  # noqa: F401
    HeterogeneousChannel)
from repro_torch.channels.registry import (  # noqa: F401
    ChannelSpec, channel_names, make_channel, parse_spec, register)
from repro_torch.channels.trace import (  # noqa: F401
    TraceChannel, load_trace, save_trace)
