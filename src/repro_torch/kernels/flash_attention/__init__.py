from . import ops, ref
from .ops import flash_attention
from .ref import ref_attention

__all__ = ["flash_attention", "ops", "ref", "ref_attention"]
