"""Architecture registry: --arch <id> resolves here."""

from typing import Dict

from .base import (SHAPES, LONG_CONTEXT_ARCHS, HybridConfig, MLAConfig,
                   ModelConfig, MoEConfig, ShapeConfig, SSMConfig,
                   reduce_for_smoke)
from .starcoder2_3b import CONFIG as STARCODER2_3B
from .qwen2_72b import CONFIG as QWEN2_72B
from .gemma_2b import CONFIG as GEMMA_2B
from .gemma3_27b import CONFIG as GEMMA3_27B
from .musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from .phi3_vision_4b import CONFIG as PHI3_VISION
from .deepseek_v3_671b import CONFIG as DEEPSEEK_V3
from .granite_moe_1b import CONFIG as GRANITE_MOE
from .mamba2_1b import CONFIG as MAMBA2_1B
from .zamba2_2b import CONFIG as ZAMBA2_2B

ARCHS: Dict[str, ModelConfig] = {c.name: c for c in [
    STARCODER2_3B, QWEN2_72B, GEMMA_2B, GEMMA3_27B, MUSICGEN_MEDIUM,
    PHI3_VISION, DEEPSEEK_V3, GRANITE_MOE, MAMBA2_1B, ZAMBA2_2B,
]}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def cell_is_runnable(arch: str, shape: str) -> bool:
    """long_500k only for sub-quadratic archs (DESIGN.md §4)."""
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True


__all__ = ["ARCHS", "SHAPES", "LONG_CONTEXT_ARCHS", "ModelConfig",
           "MoEConfig", "MLAConfig", "SSMConfig", "HybridConfig",
           "ShapeConfig", "get_arch", "cell_is_runnable", "reduce_for_smoke"]
