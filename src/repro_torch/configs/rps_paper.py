"""The paper's experimental scale: a small dense decoder for the n = 16
worker convergence studies (Tang et al. 2019, section 6)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rps-paper-mlp",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=512,
    vocab_size=256,
    max_seq=512,
    citation="Tang et al. 2019 (ICML) section 6",
)
