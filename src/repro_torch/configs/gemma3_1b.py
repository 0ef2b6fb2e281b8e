"""Gemma3-1B [hf:google/gemma-3-1b-pt] — 5:1 local:global, GQA kv=1."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    window=512,                      # local layers: 512-token sliding window
    global_every=6,                  # 5 local : 1 global
    rope_theta=1_000_000.0,
    max_seq=131_072,
    citation="hf:google/gemma-3-1b-pt",
)
