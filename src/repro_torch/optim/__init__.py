"""Optimizers, their packed state and LR schedules (port of
:mod:`repro.optim`)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, make_optimizer, momentum, sgd)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, linear_scaled_step_decay, warmup_decay)
from repro_torch.optim.statepack import (  # noqa: F401
    PACKS, StatePack, canon_pack, make_state_pack, pack_tree,
    state_bytes_breakdown, tree_bytes, unpack_tree)
