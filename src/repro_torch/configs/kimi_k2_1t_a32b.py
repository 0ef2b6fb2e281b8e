"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-param MoE, 384 experts top-8.

1T total params: one card holds the full width only with the depth cut
(the launchers' ``--layers``; one layer with its embeddings is 38.7 GB in
bf16). ``rps_mode`` / ``shard_strategy`` are the reference's (expert
shards over data x model, RS-drop gradient mode: DESIGN.md §5), carried
for its mesh trainer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="dense",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,                       # per-expert FFN width
    vocab_size=163840,
    n_experts=384,
    top_k=8,
    window=None,
    rps_mode="rps_grad",
    shard_strategy="fsdp",
    citation="arXiv:2501.kimi2",
)
