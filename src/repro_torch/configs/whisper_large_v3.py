"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder; the conv / mel
frontend is a stub.

The model takes precomputed frame embeddings (src_len = seq // 2, the
conv's stride-2 downsampling). decode_32k runs the decoder's KV cache
past Whisper's 448-token training context (a stress shape); long_500k is
skipped (full-attention decoder).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                     # decoder layers
    enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    enc_frames_ratio=2,
    window=None,
    citation="arXiv:2212.04356",
)
