"""Llama-3 405B [arXiv:2407.21783] — dense, GQA kv=8, 128k vocab, full attn.

810 GB of bf16 parameters: one card holds the full width only with the
depth cut (the launchers' ``--layers``). ``rps_mode`` / ``shard_strategy``
are the reference's (FSDP, RS-drop gradient mode: DESIGN.md §5), carried
for its mesh trainer.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    window=None,                     # full attention -> long_500k skipped
    rope_theta=500_000.0,
    rps_mode="rps_grad",
    shard_strategy="fsdp",
    citation="arXiv:2407.21783",
)
