"""starcoder2-3b [arXiv:2402.19173; hf:bigcode/starcoder2-3b].

30L, d_model=3072, 24 heads (GQA kv=2), d_ff=12288, vocab=49152.
GQA + RoPE; sliding-window 4096 attention; GELU MLP with bias-style config
reduced to bias on QKV (hf: use_bias=True).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=999_999.0,
    sliding_window=4096,
    mlp="gelu",
)
