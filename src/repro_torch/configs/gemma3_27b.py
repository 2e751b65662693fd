"""gemma3-27b [hf:google/gemma-3-27b-pt; pattern per gemma-3 tech report].

62L, d_model=5376, 32 heads (GQA kv=16), head_dim=128, d_ff=21504,
vocab=262144.  5 local (sliding window 1024) : 1 global layer pattern,
128k context.  Single RoPE theta=1e6 (the per-kind dual-theta detail is
noted in DESIGN.md as a simplification).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    local_global_pattern=("L", "L", "L", "L", "L", "G"),
    mlp="gelu_glu",
    tie_embeddings=True,
)
