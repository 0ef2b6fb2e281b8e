"""Continuous-batching serving engine (port of :mod:`repro.serve.engine`).

:class:`ContinuousEngine` serves requests with per-request admission and
iteration-level join/evict (``serve.scheduler``), a paged KV cache
(``serve.kvcache``) and optional drop-masked tensor-parallel decode
(``serve.tp``). A decode round is a Python loop of ``chunk`` decode steps
on the device with on-device sampling; the host copies the round's tokens
once. (The JAX package fuses the round into one ``lax.scan``; capturing
it as a CUDA graph is later work.) The legacy static-batch ``ServeEngine``
is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.registry import Model
from repro_torch.serve.kvcache import PagedCache, n_pages
from repro_torch.serve.scheduler import FINISHED, RUNNING, Request, Scheduler
from repro_torch.serve.tp import TPDecodeConfig, make_tp_context


@dataclasses.dataclass
class ServeReport:
    """Per-session outcome: the finished requests plus aggregate rates."""
    requests: List[Request]
    wall_s: float
    rounds: int
    prefills: int

    @property
    def tokens(self) -> int:
        return sum(len(r.generated) for r in self.requests)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.wall_s, 1e-9)

    def latencies_ms(self) -> np.ndarray:
        """Per-request arrival → finish latency."""
        return np.asarray([r.finish_ms - r.arrival_ms
                           for r in self.requests], np.float64)

    def latency_quantile(self, q: float) -> float:
        lat = self.latencies_ms()
        return float(np.quantile(lat, q)) if lat.size else float("nan")

    def outputs(self) -> Dict[int, List[int]]:
        return {r.rid: list(r.generated) for r in self.requests}


@dataclasses.dataclass
class ContinuousEngine:
    """Continuous-batching paged-KV serving engine on ``model.device``.

    ``run()`` serves a list of requests to completion: arrivals respected
    against the wall clock (or all at once with ``drain=True``), FCFS
    admission with iteration-level join/evict, per-request prefill
    scattered into the paged pool, and ``chunk``-step decode rounds over
    ``max_batch`` lanes. ``tp`` sends every decode output projection
    through the drop-masked exchange. Random draws (drop masks, sampling
    at temperature > 0) come from one ``torch.Generator`` seeded with
    ``seed`` at the start of each session.
    """
    model: Model
    params: Any
    page: int = 16
    n_blocks: int = 65                  # 64 usable + the null block
    max_batch: int = 8
    chunk: int = 8
    max_len: int = 512
    temperature: float = 0.0
    tp: Optional[TPDecodeConfig] = None
    seed: int = 0

    def __post_init__(self):
        if self.max_len % self.page:
            # the block table is sized in whole pages
            self.max_len = n_pages(self.max_len, self.page) * self.page
        self.max_pages = self.max_len // self.page
        self.device = self.model.device
        self.tp_ctx = make_tp_context(self.tp, self.model.cfg,
                                      self.max_batch)

    # -- one decode round ---------------------------------------------------

    def _round(self, pool, bt, tok, pos, n_left, gen, ch_state):
        """``chunk`` decode steps on the device. Returns (pool, emitted
        tokens (chunk, B) with -1 on idle lanes, channel state)."""
        tp_ctx = self.tp_ctx
        emitted = []
        for _ in range(self.chunk):
            masks = None
            if tp_ctx is not None:
                masks, ch_state = tp_ctx.sample_site_masks(gen, ch_state)
            active = n_left > 0
            logits, pool = self.model.decode_paged(
                self.params, pool, {"token": tok}, pos, bt, page=self.page,
                masks=masks, tp=tp_ctx)
            if self.temperature > 0:
                probs = torch.softmax(
                    logits.to(torch.float32) / self.temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = torch.argmax(logits, dim=-1)
            emitted.append(torch.where(active, nxt, -1))
            tok = torch.where(active[:, None], nxt[:, None], tok)
            pos = pos + active.to(pos.dtype)
            n_left = n_left - active.to(n_left.dtype)
        return pool, torch.stack(emitted), ch_state

    # -- session ------------------------------------------------------------

    def _check(self, r: Request) -> None:
        S = len(r.prompt)
        if S + r.max_new > self.max_len:
            raise ValueError(
                f"request {r.rid}: prompt_len {S} + max_new {r.max_new} "
                f"= {S + r.max_new} exceeds max_len {self.max_len}")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    def run(self, requests: Sequence[Request], *, drain: bool = False
            ) -> ServeReport:
        """Serve ``requests`` to completion. ``drain=True`` ignores arrival
        times (throughput mode); otherwise requests join the queue when
        the wall clock passes their ``arrival_ms``."""
        for r in requests:
            self._check(r)
        cache = PagedCache(self.model, self.page, self.n_blocks)
        sched = Scheduler(cache.alloc, max_batch=self.max_batch,
                          page=self.page, chunk=self.chunk)
        pending = sorted(requests, key=lambda r: (r.arrival_ms, r.rid))
        lanes: List[Optional[Request]] = [None] * self.max_batch
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        ch_state = (self.tp_ctx.init_state(gen)
                    if self.tp_ctx is not None else None)
        t0 = time.perf_counter()
        now = lambda: (time.perf_counter() - t0) * 1e3     # noqa: E731
        rounds = prefills = 0

        while pending or not sched.idle:
            t = now()
            while pending and (drain or pending[0].arrival_ms <= t):
                sched.add(pending.pop(0))
            if sched.idle and pending:
                time.sleep(
                    min(max(pending[0].arrival_ms - now(), 0.0), 50.0)
                    / 1e3)
                continue

            admitted, _ = sched.schedule()
            # preempted/finished requests lose their lane
            for i, r in enumerate(lanes):
                if r is not None and r.state != RUNNING:
                    lanes[i] = None

            for r in admitted:
                full = np.concatenate(
                    [r.prompt, np.asarray(r.generated, np.int32)])
                last, pcache = self.model.prefill(
                    self.params, {"tokens": self._tensor(full[None, :])},
                    paged=True)
                cache.write_prefill(pcache, r.blocks, int(full.size))
                prefills += 1
                if r.admitted_ms is None:
                    r.admitted_ms = now()
                tok0 = int(torch.argmax(last[0]))
                if r.first_token_ms is None:
                    r.first_token_ms = now()
                sched.advance(r, [tok0])
                if r.state == RUNNING:
                    lane = lanes.index(None)
                    lanes[lane] = r
                    r.lane = lane
                elif r.state == FINISHED:
                    r.finish_ms = now()

            if any(r is not None for r in lanes):
                bt = np.zeros((self.max_batch, self.max_pages), np.int64)
                pos = np.zeros(self.max_batch, np.int64)
                n_left = np.zeros(self.max_batch, np.int64)
                tok = np.zeros((self.max_batch, 1), np.int64)
                for i, r in enumerate(lanes):
                    if r is None:
                        continue
                    bt[i] = cache.block_row(r.blocks, self.max_pages)
                    pos[i] = r.pos
                    n_left[i] = r.n_left
                    tok[i, 0] = r.generated[-1]
                cache.pool, toks, ch_state = self._round(
                    cache.pool, self._tensor(bt), self._tensor(tok),
                    self._tensor(pos), self._tensor(n_left), gen, ch_state)
                toks_np = toks.cpu().numpy()       # the round's one copy
                rounds += 1
                t_end = now()
                for i, r in enumerate(lanes):
                    if r is None:
                        continue
                    k = min(self.chunk, r.n_left)
                    sched.advance(r, toks_np[:k, i].tolist())
                    if r.state == FINISHED:
                        lanes[i] = None
                        r.finish_ms = t_end

        wall = time.perf_counter() - t0
        done = sorted(requests, key=lambda r: r.rid)
        return ServeReport(requests=list(done), wall_s=wall,
                           rounds=rounds, prefills=prefills)


def make_requests(trace: Sequence[Tuple[float, int, int]], vocab: int,
                  seed: int = 0) -> List[Request]:
    """Materialise a ``netsim.request_trace`` load (arrival_ms,
    prompt_len, max_new) into requests with random prompts."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, size=int(pl)),
                    max_new=int(mn), arrival_ms=float(am))
            for i, (am, pl, mn) in enumerate(trace)]
