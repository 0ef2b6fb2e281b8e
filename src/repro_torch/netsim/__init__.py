from repro_torch.netsim.sim import NetConfig, request_trace  # noqa: F401
