"""What both launchers share beyond the reference's flags: the config
they build, ``--arch`` reduced unless ``--full``, then cut to
``--layers`` layers at full width."""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config

# configs one 80 GB card holds at full width only with their depth cut
NEEDS_LAYERS = ("llama3-405b", "mixtral-8x22b", "kimi-k2-1t-a32b")


def add_model_flags(ap: argparse.ArgumentParser) -> None:
    """The depth cut, ``--layers N``."""
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to its first N layers (full width "
                         "on one 80 GB card: " + ", ".join(NEEDS_LAYERS)
                         + " need it; 4, 4 and 1 fit)")


def arch_config(args):
    """The config the launchers build: ``--arch``, reduced unless
    ``--full``, then cut to ``--layers`` layers."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        if args.layers < 1:
            raise ValueError(f"--layers {args.layers}: need >= 1")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg
