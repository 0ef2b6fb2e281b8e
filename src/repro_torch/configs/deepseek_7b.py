"""DeepSeek-7B [arXiv:2401.02954] — llama-arch, MHA (kv=32), full attention."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    window=None,                     # full attention -> long_500k skipped
    citation="arXiv:2401.02954",
)
