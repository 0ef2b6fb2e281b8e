"""Architecture config (port of :mod:`repro.configs.base`).

Only the dense-family fields the serving path reads are kept; the other
families land with their models.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Dense decoder-only transformer hyper-parameters (GQA, RoPE,
    optional sliding window with a local:global pattern)."""
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default d_model // n_heads
    window: Optional[int] = None              # sliding-window size
    # every `global_every`-th layer is full attention (gemma3: 6)
    global_every: Optional[int] = None
    n_experts: int = 0
    max_seq: int = 131_072
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; the lm head masks the
        padding."""
        return -(-self.vocab_size // 256) * 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same topology, tiny dims, f32."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 64) if self.window else None,
            max_seq=4096,
            dtype="float32",
        )
