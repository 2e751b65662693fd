from . import ops, ref
from .ops import ssd
from .ref import ref_ssd

__all__ = ["ops", "ref", "ref_ssd", "ssd"]
