"""musicgen-medium [arXiv:2306.05284; hf:facebook/musicgen-medium].

48L decoder-only over EnCodec tokens: d_model=1536, 24 heads (full MHA,
kv=24), d_ff=6144, 4 codebooks x vocab=2048.  The EnCodec frontend is a
STUB per the task spec: the data pipeline supplies (B, K, S) token grids
with the delay pattern already applied; the backbone embeds the K codebooks
additively and predicts K vocab heads.  RoPE replaces the original
sinusoidal positions (TPU-idiomatic; noted in DESIGN.md).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    rope_theta=10_000.0,
    mlp="gelu",
)
