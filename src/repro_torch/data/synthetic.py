"""Deterministic synthetic data pipeline (port of
:mod:`repro.data.synthetic`, its numpy draws copied so that the batches
are bitwise the JAX package's).

Two task families drive the convergence experiments:

- :class:`TeacherTask` — teacher–student softmax classification; each
  worker draws from its own shifted input distribution (the paper's ζ²
  heterogeneity);
- :class:`CharLMTask` — a Markov-chain character LM with a known entropy
  floor.

Streams are keyed by (seed, worker, step): deterministic and resumable.
Batches are numpy draws returned as tensors on ``device`` (CUDA unless
the caller asks for the CPU), with int32 tokens and labels as in the
reference.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


# the most (batch × vocab) comparisons a position of the char-LM draw
# makes at once; above it, a bisection a row
_COUNT_MAX = 1 << 16


@functools.lru_cache(maxsize=16)
def _markov_cdf(vocab: int, temp: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(vocab, vocab)) * temp
    P = np.exp(logits - logits.max(-1, keepdims=True))
    P /= P.sum(-1, keepdims=True)
    return np.cumsum(P, axis=-1)


@dataclasses.dataclass(frozen=True)
class TeacherTask:
    d_in: int = 32
    n_classes: int = 10
    hetero: float = 0.1         # worker distribution shift strength
    seed: int = 0
    device: str = "cuda"

    def teacher(self) -> torch.Tensor:
        rng = np.random.default_rng(self.seed)
        return torch.as_tensor(
            rng.normal(size=(self.d_in, self.n_classes)),
            dtype=torch.float32, device=resolve_device(self.device))

    def batch(self, worker: int, step: int, batch_size: int):
        """(x, y) for one worker step; the label is the teacher's argmax
        over the f32 logits (int32)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + worker) * 1_000_003 + step)
        shift_rng = np.random.default_rng(self.seed * 7 + worker)
        shift = shift_rng.normal(size=(self.d_in,)) * self.hetero
        x = rng.normal(size=(batch_size, self.d_in)) + shift
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=resolve_device(self.device))
        y = torch.argmax(x @ self.teacher(), dim=-1).to(torch.int32)
        return x, y


@dataclasses.dataclass(frozen=True)
class CharLMTask:
    vocab: int = 64
    seq_len: int = 64
    order_temp: float = 1.0
    seed: int = 0
    device: str = "cuda"

    def transition(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        logits = rng.normal(size=(self.vocab, self.vocab)) * self.order_temp
        P = np.exp(logits - logits.max(-1, keepdims=True))
        return P / P.sum(-1, keepdims=True)

    def batch(self, worker: int, step: int, batch_size: int):
        """{tokens, labels} (int32) of Markov sequences."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + worker) * 1_000_003 + step + 1)
        toks = np.empty((batch_size, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch_size)
        # inverse-CDF Markov sampling (cached tables): the first token whose
        # cumulative probability exceeds u, 0 when none does (u at or above
        # a row's rounded total) -- the reference's argmax of
        # ``u < cdf[row]``. A row is nondecreasing, so that token is the
        # count of its entries at or below u: for a small table counted
        # for the whole batch at once, for a large one found by bisection
        # row by row (a (batch, vocab) comparison a position would cost
        # more than the bisections)
        cdf = _markov_cdf(self.vocab, self.order_temp, self.seed)
        u = rng.random((self.seq_len, batch_size))
        for t in range(self.seq_len):
            if batch_size * self.vocab <= _COUNT_MAX:
                k = np.count_nonzero(cdf[toks[:, t]] <= u[t][:, None], -1)
            else:
                k = np.array([np.searchsorted(cdf[r], v, side="right")
                              for r, v in zip(toks[:, t], u[t])])
            toks[:, t + 1] = np.where(k < self.vocab, k, 0)
        dev = resolve_device(self.device)
        return {"tokens": torch.as_tensor(toks[:, :-1].astype(np.int32),
                                          device=dev),
                "labels": torch.as_tensor(toks[:, 1:].astype(np.int32),
                                          device=dev)}

    def entropy_floor(self) -> float:
        P = self.transition()
        return float(-(P * np.log(P + 1e-12)).sum(-1).mean())


def char_lm_stream(task: CharLMTask, worker: int, batch_size: int
                   ) -> Iterator[dict]:
    step = 0
    while True:
        yield task.batch(worker, step, batch_size)
        step += 1


def make_worker_streams(task, n_workers: int, batch_size: int):
    """Per-step stacked batches for the n-worker simulator: returns
    fn(step) -> batch with leading dim n_workers (a tuple (x, y) or a
    dict, as the task's batches)."""
    def get(step: int):
        batches = [task.batch(w, step, batch_size) for w in range(n_workers)]
        if isinstance(batches[0], tuple):
            return (torch.stack([b[0] for b in batches]),
                    torch.stack([b[1] for b in batches]))
        return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    return get
