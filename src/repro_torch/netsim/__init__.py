from repro_torch.netsim.sim import (  # noqa: F401
    NetConfig, cost_reduction_curve, export_trace, request_trace, simulate,
    speedup_curve)
