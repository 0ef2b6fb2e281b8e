"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

The transformer backbone only — the ViT / SigLIP encoder and projector
are a stub: the model takes precomputed patch embeddings (anyres tiling
gives up to 576 base patches; 576 image tokens are budgeted).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    window=4096,                     # Mistral sliding-window attention
    n_patches=576,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
