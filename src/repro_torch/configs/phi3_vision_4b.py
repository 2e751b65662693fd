"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini text backbone: 32L, d_model=3072, 32 heads (kv=32), d_ff=8192,
vocab=32064, SwiGLU.  The CLIP ViT-L/14 frontend is a STUB per the task
spec: ``input_specs()`` provides precomputed patch embeddings
(B, num_image_tokens, 1024) which the model projects into d_model and
splices over the first ``num_image_tokens`` positions.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    num_image_tokens=256,
    rope_theta=10_000.0,
    mlp="silu_glu",
)
