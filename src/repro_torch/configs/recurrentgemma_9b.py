"""RecurrentGemma-9B [arXiv:2402.19427] — RG-LRU + local attention, 2:1.

Repeating unit: (rec, rec, attn); 26 RG-LRU layers and 12 local-attention
layers with a 2048-token window.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    window=2048,                     # local attention window
    block_pattern=("rec", "rec", "attn"),
    d_state=4096,                    # RG-LRU width = d_model
    citation="arXiv:2402.19427",
)
