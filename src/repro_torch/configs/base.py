"""Architecture and input-shape configs (port of
:mod:`repro.configs.base`).

Every field the model families read is kept (dense with its MoE variant,
ssm, hybrid, audio, vlm), with the reference's parameter count and its
6·N·D model FLOPs. The reference's activation-sharding fields
(``shard_acts``, ``act_batch_axis``) are left out: the port has no mesh
yet. ``rps_mode`` and ``shard_strategy`` are carried as the reference
sets them and not acted on: they pick the mesh trainer's mode and
sharding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An input shape: ``seq_len`` tokens, ``global_batch`` sequences, of
    kind "train", "prefill" or "decode"."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Architecture hyper-parameters. ``family`` selects the model:
    "dense" (decoder-only transformer: GQA, RoPE, optional sliding window
    with a local:global pattern, optional MoE FFN when ``n_experts`` > 0),
    "ssm" (RWKV-6, attention-free),
    "hybrid" (RecurrentGemma: RG-LRU recurrent layers interleaved with
    local attention by ``block_pattern``),
    "audio" (Whisper-style encoder-decoder on precomputed frame
    embeddings: ``enc_layers`` bidirectional encoder layers, decoder
    layers with cross-attention) or
    "vlm" (LLaVA-style dense decoder with ``n_patches`` precomputed patch
    embeddings before the tokens)."""
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
    # audio / vlm frontend stubs
    n_patches: int = 0                        # vlm: image tokens per example
    enc_layers: int = 0                       # audio: encoder layers
    enc_frames_ratio: int = 2                 # audio: src_len = seq // ratio
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
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            enc_layers=2 if self.enc_layers else 0,
            max_seq=4096,
            dtype="float32",
        )

    # -- parameter counting (MODEL_FLOPS = 6·N·D), the reference's
    # arithmetic ----------------------------------------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, h, kv, hd, ff = (self.d_model, self.n_heads, self.n_kv_heads,
                            self.hd, self.d_ff)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d      # q, k+v, o
        if self.is_moe:
            experts = self.top_k if active_only else self.n_experts
            mlp = experts * 3 * d * ff + d * self.n_experts   # gate included
        else:
            mlp = 3 * d * ff                                  # gated MLP
        rec = 0
        per_layer_attn = attn
        if self.family == "ssm":                              # rwkv6
            per_layer_attn = 0
            rec = 6 * d * d + 2 * d                           # r,k,v,g,o,decay
            mlp = 2 * d * ff                                  # channel mix
        layers = self.n_layers
        if self.family == "hybrid" and self.block_pattern:
            pat = self.block_pattern
            n_rec = sum(1 for i in range(layers) if pat[i % len(pat)] == "rec")
            n_att = layers - n_rec
            width = self.d_state or d
            rec_params = 3 * d * width + 2 * width
            body = n_att * (attn + mlp) + n_rec * (rec_params + mlp)
        else:
            body = layers * (per_layer_attn + rec + mlp)
        if self.family == "audio":
            # the encoder, and the decoder's cross-attention
            body += self.enc_layers * (attn + mlp) + self.n_layers * attn
        emb = self.vocab_size * d
        return body + 2 * emb + layers * 2 * d

    def model_flops(self, tokens: int) -> float:
        """6·N·D (dense) or 6·N_active·D (MoE)."""
        return 6.0 * self.param_count(active_only=True) * tokens

    def supports_long_context(self) -> bool:
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None   # SWA / local:global dense archs

    def has_decode(self) -> bool:
        return True      # every registry architecture is or holds a decoder

    def runs_shape(self, shape: "ShapeConfig | str") -> bool:
        shape = SHAPES[shape] if isinstance(shape, str) else shape
        if shape.name == "long_500k":
            return self.supports_long_context()
        return True
