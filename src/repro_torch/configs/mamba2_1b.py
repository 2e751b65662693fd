"""mamba2-1.3b [arXiv:2405.21060; state-spaces/mamba2-1.3b].

48L attention-free SSD blocks: d_model=2048, expand=2 (d_inner=4096),
head_dim=64 (64 ssm heads), d_state=128, conv kernel 4, chunk 256,
vocab=50280.  Tied embeddings (as released).
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,               # unused: attention-free
    num_kv_heads=1,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256,
                  conv_kernel=4, n_groups=1),
    tie_embeddings=True,
)
