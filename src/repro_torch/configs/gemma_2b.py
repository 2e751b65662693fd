"""gemma-2b [arXiv:2403.08295; hf:google/gemma-2b].

18L, d_model=2048, 8 heads, MQA (kv=1), head_dim=256, d_ff=16384,
vocab=256000.  GeGLU MLP, tied embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    rope_theta=10_000.0,
    mlp="gelu_glu",
    tie_embeddings=True,
)
