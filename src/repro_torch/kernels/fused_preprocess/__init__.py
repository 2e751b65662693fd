from . import ops, ref
from .ops import fused_preprocess
from .ref import ref_preprocess

__all__ = ["fused_preprocess", "ops", "ref", "ref_preprocess"]
