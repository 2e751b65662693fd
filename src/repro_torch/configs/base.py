"""Model + run configuration dataclasses.

One :class:`ModelConfig` covers all ten assigned architecture families via
optional sub-configs (MoE / MLA / SSM / hybrid / multi-codebook / vlm-stub).
Shape points (train_4k / prefill_32k / decode_32k / long_500k) are
:class:`ShapeConfig`; the launcher crosses them with architectures.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    num_shared: int = 0           # always-on shared experts (deepseek)
    first_dense_layers: int = 0   # leading layers use dense FFN (deepseek: 3)
    capacity_factor: float = 1.25
    router: str = "softmax"       # softmax | sigmoid (deepseek v3)
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_kernel: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class HybridConfig:
    shared_attn_period: int = 6   # one shared attention block every N ssm blocks
    shared_attn_heads: int = 32
    shared_attn_kv_heads: int = 32
    shared_attn_d_ff: int = 0     # 0: no mlp in shared block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention flavor
    attention: str = "gqa"        # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0       # 0 = all-global
    local_global_pattern: Tuple[str, ...] = ()  # e.g. ("L",)*5+("G",) cycled
    # mlp flavor
    mlp: str = "silu_glu"         # silu_glu | gelu_glu | gelu
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # modality frontends (stubs per task spec)
    num_codebooks: int = 0        # musicgen: EnCodec codebooks
    num_image_tokens: int = 0     # phi3v: precomputed patch embeddings
    # multi-token prediction (deepseek v3)
    mtp_depth: int = 0
    # numerics / misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "full"           # none | dots | full (full = nothing_saveable)
    # beyond-paper perf knobs (hillclimbed in EXPERIMENTS.md §Perf)
    seq_shard_attn: bool = False  # sequence-shard long decode caches
    fsdp_params: bool = True      # ZeRO-3 param sharding over (pod, data)
    adam_moment_dtype: str = "float32"
    vocab_pad_multiple: int = 256  # pad embeddings/logits so vocab shards

    # -- derived -------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def d_inner(self) -> int:
        return self.expand_dim if self.ssm else self.num_heads * self.head_dim

    @property
    def expand_dim(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.expand_dim // self.ssm.head_dim if self.ssm else 0

    def layer_kind(self, layer_idx: int) -> str:
        """'G' global attn, 'L' local attn for this layer index."""
        if not self.local_global_pattern:
            return "L" if self.sliding_window else "G"
        return self.local_global_pattern[layer_idx % len(self.local_global_pattern)]

    def param_count_estimate(self) -> int:
        """6·N·D model-flops N term: total (dense) params."""
        from repro_torch.models.model import build_model  # late import
        from repro_torch.models import param as P
        return P.count_params(build_model(self).param_specs())

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs for which long_500k is runnable (sub-quadratic sequence mechanism);
# pure full-attention archs skip it per the task spec (see DESIGN.md §4).
LONG_CONTEXT_ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "gemma3-27b")


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one train step, no NaNs)."""
    kw = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads * 4 // max(cfg.num_heads, 1))),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
        remat="none",
    )
    if cfg.local_global_pattern:
        # keep both kinds + exercise the tail path (5 = 2 periods + 1 tail)
        kw["local_global_pattern"] = ("L", "G")
        kw["num_layers"] = 5
        kw["sliding_window"] = min(cfg.sliding_window or 64, 64)
    elif cfg.sliding_window:
        kw["sliding_window"] = 64
    if cfg.moe:
        kw["moe"] = MoEConfig(num_experts=8, top_k=2, d_expert=64,
                              num_shared=min(cfg.moe.num_shared, 1),
                              first_dense_layers=min(cfg.moe.first_dense_layers, 1),
                              router=cfg.moe.router)
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32, rope_head_dim=16,
                              nope_head_dim=32, v_head_dim=32)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=16, expand=2, chunk_size=32,
                              conv_kernel=cfg.ssm.conv_kernel,
                              n_groups=cfg.ssm.n_groups)
        kw["num_layers"] = 4
    if cfg.hybrid:
        kw["hybrid"] = HybridConfig(shared_attn_period=2, shared_attn_heads=4,
                                    shared_attn_kv_heads=4,
                                    shared_attn_d_ff=cfg.hybrid.shared_attn_d_ff
                                    and 256)
        kw["num_layers"] = 4
    if cfg.num_codebooks:
        kw["num_codebooks"] = 2
    if cfg.num_image_tokens:
        kw["num_image_tokens"] = 8
    if cfg.mtp_depth:
        kw["mtp_depth"] = 1
    return cfg.with_(**kw)
