"""RWKV6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent decay."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,                      # rwkv6 heads (d_model/64)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    d_state=64,
    citation="arXiv:2404.05892",
)
