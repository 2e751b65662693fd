from . import ops, ref
from .ops import decode_attention, decode_attention_partial
from .ref import decode_attention_partial_ref, decode_attention_ref

__all__ = ["decode_attention", "decode_attention_partial",
           "decode_attention_partial_ref", "decode_attention_ref", "ops",
           "ref"]
