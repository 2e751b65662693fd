"""deepseek-v3-671b [arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3].

61L, d_model=7168, 128 heads with MLA (q_lora=1536, kv_lora=512, rope
head 64, nope head 128, v head 128), vocab=129280.  MoE: 1 shared + 256
routed experts, top-8, expert FFN hidden=2048 (the spec's d_ff), first 3
layers dense FFN (hidden 18432 per the paper), sigmoid router with
renormalized top-k weights.  Multi-token prediction depth 1.
Adam moments kept in bf16 (fits one pod; see EXPERIMENTS.md memory table).
"""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # nominal; MLA replaces KV heads with latents
    head_dim=128,
    d_ff=18432,                # dense FFN width of the 3 leading layers
    vocab_size=129280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  first_dense_layers=3, router="sigmoid"),
    mtp_depth=1,
    rope_theta=10_000.0,
    mlp="silu_glu",
    adam_moment_dtype="bfloat16",
)
