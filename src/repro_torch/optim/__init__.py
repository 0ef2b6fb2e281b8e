"""Optimizers and LR schedules (port of :mod:`repro.optim`, unpacked f32
state only)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, make_optimizer, momentum, sgd)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, linear_scaled_step_decay, warmup_decay)
