"""Tree checkpoints (port of :mod:`repro.checkpoint`)."""
from repro_torch.checkpoint.ckpt import (load_pytree, load_state,  # noqa: F401
                                         save_pytree, save_state)
