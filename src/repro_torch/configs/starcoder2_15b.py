"""StarCoder2-15B [arXiv:2402.19173] — dense, GQA kv=4, RoPE, SWA(4096)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    window=4096,                     # StarCoder2 trains with 4k sliding window
    rope_theta=100_000.0,
    citation="arXiv:2402.19173",
)
