"""Architecture config (port of :mod:`repro.configs.base`).

Only the fields the ported families (dense with its MoE variant, ssm,
hybrid) read are kept; the vlm and audio families' fields land with their
models. ``rps_mode`` and ``shard_strategy`` are carried as the reference
sets them and not acted on: they pick the mesh trainer's mode and
sharding, and the port has no mesh yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture hyper-parameters. ``family`` selects the model:
    "dense" (decoder-only transformer: GQA, RoPE, optional sliding window
    with a local:global pattern, optional MoE FFN when ``n_experts`` > 0),
    "ssm" (RWKV-6, attention-free) or
    "hybrid" (RecurrentGemma: RG-LRU recurrent layers interleaved with
    local attention by ``block_pattern``)."""
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
    # MoE: n_experts experts, top_k of them per token, each holding at most
    # ceil(tokens·top_k / n_experts · capacity_factor) assignments
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (RecurrentGemma): repeating unit, e.g. ("rec", "rec", "attn")
    block_pattern: Optional[Tuple[str, ...]] = None
    # rwkv6 / rglru recurrence width
    d_state: Optional[int] = None
    max_seq: int = 131_072
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
    # RPS integration mode and parameter sharding of the mesh trainer
    # (carried, not acted on: the port has no mesh yet)
    rps_mode: str = "rps_model"               # "rps_model" | "rps_grad"
    shard_strategy: str = "tp"                # "tp" | "fsdp"
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
        """Smoke-test variant: same topology, tiny dims (at most 4 experts,
        top 2), f32."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        pattern = self.block_pattern
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=2 if pattern is None else max(2, len(pattern)),
            d_model=min(self.d_model, 256),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_state=min(self.d_state, 64) if self.d_state else None,
            window=min(self.window, 64) if self.window else None,
            max_seq=4096,
            dtype="float32",
        )
