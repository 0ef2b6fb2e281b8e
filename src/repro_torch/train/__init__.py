"""Training (port of :mod:`repro.train`): the single-device n-worker
simulator."""
from repro_torch.train.simulator import (  # noqa: F401
    SimulatorConfig, make_exchange_plan, make_sim_step, run_simulation)
