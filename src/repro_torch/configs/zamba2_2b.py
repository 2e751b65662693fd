"""zamba2-2.7b [arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B].

54 Mamba2 layers (d_model=2560, expand=2 -> d_inner=5120, 80 heads @ 64,
d_state=64) with ONE shared full-attention transformer block invoked every
6 mamba layers (9 invocations share parameters), 32 heads, d_ff=10240,
vocab=32000.  (Zamba2's per-invocation LoRA deltas on the shared block are
omitted — noted in DESIGN.md.)
"""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    attention="gqa",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk_size=256,
                  conv_kernel=4, n_groups=1),
    hybrid=HybridConfig(shared_attn_period=6, shared_attn_heads=32,
                        shared_attn_kv_heads=32, shared_attn_d_ff=10240),
    mlp="gelu_glu",
)
