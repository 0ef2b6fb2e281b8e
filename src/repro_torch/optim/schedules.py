"""LR schedules (port of :mod:`repro.optim.schedules`).
``linear_scaled_step_decay`` is the paper's recipe: linear scaling with
worker count (Goyal et al. 2017), gradual warmup over the first W steps,
10× decays at fixed fractions of the run. Each schedule maps a step to
a Python float."""
from __future__ import annotations


def constant(lr: float):
    return lambda step: float(lr)


def warmup_decay(base_lr: float, warmup: int, total: int):
    def f(step):
        s = float(step)
        warm = base_lr * min(1.0, (s + 1) / max(warmup, 1))
        frac = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return warm * (1.0 - 0.9 * frac)
    return f


def linear_scaled_step_decay(base_lr: float, n_workers: int, warmup: int,
                             decay_steps=(0.5, 0.75), total: int = 1000,
                             decay: float = 0.1):
    """Paper recipe: lr = base·n with warmup and 10× drops."""
    scaled = base_lr * n_workers
    marks = tuple(int(d * total) for d in decay_steps)

    def f(step):
        s = float(step)
        lr = scaled * min(1.0, (s + 1) / max(warmup, 1))
        for m in marks:
            if s >= m:
                lr = lr * decay
        return lr
    return f
