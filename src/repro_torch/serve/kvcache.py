"""Paged KV cache: fixed-size blocks and a free-list allocator (port of
:mod:`repro.serve.kvcache`).

The pool is one flat slot array per layer, (n_slots = n_blocks·page, kvh,
hd), carved into ``page``-token blocks handed out by a host-side free
list. Each request owns a block table — the ordered block ids covering
its positions — and decode reads the pool through it, so cache memory
scales with live tokens. Block 0 is the reserved null block: unallocated
table entries and inactive lanes point at it, and the decode mask hides
whatever it holds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

NULL_BLOCK = 0


def n_pages(n_tokens: int, page: int) -> int:
    return -(-n_tokens // page)


class BlockAllocator:
    """Host-side free list over the pool's block ids. Ids
    ``[reserved, n_blocks)`` are allocatable, lowest first (so a fresh
    pool hands out ascending contiguous blocks); freed blocks are
    recycled LIFO."""

    def __init__(self, n_blocks: int, reserved: int = 1):
        if n_blocks <= reserved:
            raise ValueError(f"need n_blocks > {reserved} (the null "
                             f"block), got {n_blocks}")
        self.n_blocks = int(n_blocks)
        self.reserved = int(reserved)
        # stack: pop() takes from the end, so store descending
        self._free: List[int] = list(range(n_blocks - 1, reserved - 1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        return self.n_blocks - self.reserved

    def alloc(self, k: int) -> Optional[List[int]]:
        """k blocks, or None when the pool cannot cover them (all or
        nothing: a partial grab would deadlock two growing requests)."""
        if k < 0:
            raise ValueError(f"alloc({k})")
        if k > len(self._free):
            return None
        return [self._free.pop() for _ in range(k)]

    def free(self, ids: List[int]) -> None:
        for b in ids:
            if not self.reserved <= b < self.n_blocks:
                raise ValueError(f"freeing foreign block {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        self._free.extend(reversed(ids))


@dataclasses.dataclass
class PagedCache:
    """The device pool and its host-side accounting for one serving
    session. ``pool`` is the model's per-layer slot list
    (``Model.init_paged``), updated in place."""
    model: Any
    page: int
    n_blocks: int
    pool: Any = None

    def __post_init__(self):
        self.n_slots = self.n_blocks * self.page
        self.alloc = BlockAllocator(self.n_blocks)
        if self.pool is None:
            self.pool = self.model.init_paged(self.n_slots)

    def write_prefill(self, cache: list, blocks: List[int],
                      length: int) -> None:
        """Scatter prefill K/V rows [0, length) of every layer into the
        request's blocks (in place)."""
        slots = torch.as_tensor(self.slot_ids(blocks)[:length],
                                device=self.pool[0]["k"].device)
        for dst, src in zip(self.pool, cache):
            for leaf in ("k", "v"):
                dst[leaf][slots] = src[leaf][0, :length].to(dst[leaf].dtype)

    def slot_ids(self, blocks: List[int]) -> np.ndarray:
        """Flat slot ids covered by a block list, in position order."""
        b = np.asarray(blocks, np.int64)
        return (b[:, None] * self.page
                + np.arange(self.page)[None, :]).reshape(-1)

    def block_row(self, blocks: List[int], max_pages: int) -> np.ndarray:
        """One block-table row, null-padded to the static table width."""
        if len(blocks) > max_pages:
            raise ValueError(f"{len(blocks)} blocks > table width "
                             f"{max_pages}")
        row = np.full(max_pages, NULL_BLOCK, np.int64)
        row[:len(blocks)] = blocks
        return row

    def gather_contiguous(self, blocks: List[int], length: int) -> list:
        """Per layer, the contiguous (1, length, kvh, hd) K/V view of one
        request."""
        slots = torch.as_tensor(self.slot_ids(blocks)[:length],
                                device=self.pool[0]["k"].device)
        return [{leaf: layer[leaf][slots][None] for leaf in ("k", "v")}
                for layer in self.pool]
