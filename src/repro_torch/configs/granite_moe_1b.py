"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16 heads (GQA kv=8), vocab=49155.  MoE throughout:
32 experts, top-8, expert FFN hidden=512 (the spec's d_ff), softmax router.
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512, router="softmax"),
    rope_theta=10_000.0,
    mlp="silu_glu",
)
