"""Mixtral-8x22B [arXiv:2401.04088] — 8 experts top-2, GQA kv=8, SWA."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="dense",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    top_k=2,
    window=4096,                     # sliding-window attention
    citation="arXiv:2401.04088",
)
