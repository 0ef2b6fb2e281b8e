"""Continuous-batching scheduler (port of :mod:`repro.serve.scheduler`;
pure Python, as there).

The scheduler owns request states and the block-table accounting against
a :class:`~repro_torch.serve.kvcache.BlockAllocator`; the engine drives it
between decode rounds:

    states:  WAITING ──admit──▶ RUNNING ──done──▶ FINISHED
                 ▲                  │
                 └────preempt───────┘   (blocks freed, recompute on readmit)

Policy: strict FCFS admission by (arrival_ms, rid) with head-of-line
blocking; before each round every running request's blocks are grown to
cover its next ``chunk`` writes, preempting the *youngest* running request
on OOM; a preempted request keeps its tokens and is re-prefilled on
readmission.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.kvcache import BlockAllocator, n_pages

WAITING, RUNNING, FINISHED = "WAITING", "RUNNING", "FINISHED"


@dataclasses.dataclass
class Request:
    """One generation request and its runtime bookkeeping."""
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new: int
    arrival_ms: float = 0.0
    # -- runtime ----------------------------------------------------------
    state: str = WAITING
    blocks: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    pos: int = 0                        # next KV write position
    lane: Optional[int] = None
    n_preempt: int = 0
    admitted_ms: Optional[float] = None
    first_token_ms: Optional[float] = None
    finish_ms: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new < 1:
            raise ValueError(f"max_new={self.max_new} must be >= 1")

    @property
    def prefill_len(self) -> int:
        """Tokens to (re-)prefill: prompt + everything generated so far."""
        return len(self.prompt) + len(self.generated)

    @property
    def n_left(self) -> int:
        return self.max_new - len(self.generated)

    @property
    def total_slots(self) -> int:
        """KV slots the request ever writes (the final token is emitted,
        never cached)."""
        return len(self.prompt) + self.max_new - 1

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new


class Scheduler:
    def __init__(self, alloc: BlockAllocator, *, max_batch: int, page: int,
                 chunk: int = 8):
        self.alloc = alloc
        self.max_batch = int(max_batch)
        self.page = int(page)
        self.chunk = int(chunk)
        self.waiting: List[Request] = []
        self.running: List[Request] = []

    # -- queue ops ---------------------------------------------------------

    def add(self, req: Request) -> None:
        if req.state != WAITING:
            raise ValueError(f"request {req.rid} is {req.state}")
        if n_pages(req.total_slots, self.page) > self.alloc.capacity:
            raise ValueError(
                f"request {req.rid} needs "
                f"{n_pages(req.total_slots, self.page)} blocks but the "
                f"pool only has {self.alloc.capacity}")
        self.waiting.append(req)
        self.waiting.sort(key=self._key)

    @staticmethod
    def _key(r: Request) -> Tuple[float, int]:
        return (r.arrival_ms, r.rid)

    def _need_blocks(self, r: Request) -> int:
        """Blocks covering the next chunk of writes (or the request's
        lifetime total, whichever is smaller), beyond what it holds."""
        horizon = min(max(r.pos, r.prefill_len) + self.chunk, r.total_slots)
        return max(n_pages(horizon, self.page) - len(r.blocks), 0)

    def _preempt_youngest(self, spare: Optional[Request]) -> Optional[Request]:
        victims = [r for r in self.running if r is not spare]
        if not victims:
            return None
        v = max(victims, key=self._key)
        self._preempt(v)
        return v

    def _preempt(self, r: Request) -> None:
        self.alloc.free(r.blocks)
        r.blocks = []
        r.pos = 0
        r.lane = None
        r.state = WAITING
        r.n_preempt += 1
        self.running.remove(r)
        self.waiting.append(r)
        self.waiting.sort(key=self._key)

    # -- the per-round decision --------------------------------------------

    def schedule(self) -> Tuple[List[Request], List[Request]]:
        """One iteration boundary: grow running requests, then admit.

        Returns (admitted, preempted). Admitted requests must be prefilled
        by the caller (``pos`` is set to ``prefill_len``); preempted
        requests have lost their lane and blocks.
        """
        preempted: List[Request] = []
        # (a) grow, oldest first — older requests steal from younger ones
        for r in sorted(self.running, key=self._key):
            if r not in self.running:       # evicted by an older grower
                continue
            while True:
                need = self._need_blocks(r)
                if need == 0:
                    break
                got = self.alloc.alloc(need)
                if got is not None:
                    r.blocks.extend(got)
                    break
                v = self._preempt_youngest(spare=r)
                if v is None or v is r:
                    break
                preempted.append(v)
        # (b) admit, FCFS with head-of-line blocking
        admitted: List[Request] = []
        while self.waiting and len(self.running) < self.max_batch:
            r = self.waiting[0]
            horizon = min(r.prefill_len + self.chunk, r.total_slots)
            need = n_pages(max(horizon, r.prefill_len), self.page)
            got = self.alloc.alloc(need)
            if got is None:
                break                        # head blocks everyone behind it
            self.waiting.pop(0)
            r.blocks = got
            r.pos = r.prefill_len
            r.state = RUNNING
            self.running.append(r)
            admitted.append(r)
        return admitted, preempted

    # -- progress from the engine ------------------------------------------

    def advance(self, r: Request, tokens: List[int]) -> None:
        """Record new tokens for a running request and retire it at
        max_new. Invariant: ``pos = prompt + generated − 1`` (the latest
        token is emitted but its KV write is the next decode step's)."""
        if r.state != RUNNING:
            raise ValueError(f"request {r.rid} is {r.state}")
        r.generated.extend(int(t) for t in tokens)
        r.pos = len(r.prompt) + len(r.generated) - 1
        if r.done:
            self.finish(r)

    def finish(self, r: Request) -> None:
        self.alloc.free(r.blocks)
        r.blocks = []
        r.lane = None
        r.state = FINISHED
        self.running.remove(r)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.running
