"""Htype system (§3.3).

An htype declares what samples in a tensor are expected to look like: dtype,
dimensionality constraints, and a default sample codec.  Typed tensors make
framework handover well-defined and enable layout/visualization decisions.

Meta-htypes wrap a base htype:

    sequence[image]   -- a sample is an ordered list of image samples
    link[image]       -- a sample is a reference (url/key) into another
                         storage provider, resolved lazily (§4.4)

``parse_htype("sequence[image]")`` -> (meta="sequence", base="image").
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class HtypeSpec:
    name: str
    default_dtype: Optional[str] = None     # enforced if tensor doesn't override
    ndim: Optional[Tuple[int, ...]] = None  # allowed sample ndims (None = any)
    default_codec: str = "raw"
    display: str = "secondary"              # visualizer layout hint: primary/secondary/overlay
    extra: Dict[str, object] = field(default_factory=dict)

    def validate(self, arr: np.ndarray, dtype_override: Optional[str] = None) -> None:
        want = np.dtype(dtype_override or self.default_dtype) if (
            dtype_override or self.default_dtype) else None
        if want is not None and arr.dtype != want:
            raise TypeError(
                f"htype {self.name!r} expects dtype {want}, got {arr.dtype}")
        if self.ndim is not None and arr.ndim not in self.ndim:
            raise ValueError(
                f"htype {self.name!r} expects ndim in {self.ndim}, got {arr.ndim}"
                f" (shape {arr.shape})")


_REGISTRY: Dict[str, HtypeSpec] = {}


def register_htype(spec: HtypeSpec) -> HtypeSpec:
    _REGISTRY[spec.name] = spec
    return spec


# generic permits anything; it is the default htype.
register_htype(HtypeSpec("generic"))
register_htype(HtypeSpec("image", default_dtype="uint8", ndim=(2, 3),
                         default_codec="quant8", display="primary"))
register_htype(HtypeSpec("video", default_dtype="uint8", ndim=(4,),
                         default_codec="zlib", display="primary",
                         extra={"keyframe_stride": 8}))
register_htype(HtypeSpec("audio", default_dtype="float32", ndim=(1, 2),
                         default_codec="zlib", display="primary"))
register_htype(HtypeSpec("bbox", default_dtype="float32", ndim=(1, 2),
                         display="overlay", extra={"coords": "LTRB"}))
register_htype(HtypeSpec("class_label", default_dtype="int64", ndim=(0, 1),
                         display="overlay"))
register_htype(HtypeSpec("text", default_dtype="uint8", ndim=(1,),
                         default_codec="zlib", display="secondary"))
register_htype(HtypeSpec("binary_mask", default_dtype="uint8", ndim=(2, 3),
                         default_codec="zlib", display="overlay"))
register_htype(HtypeSpec("segment_mask", default_dtype="int32", ndim=(2,),
                         default_codec="zlib", display="overlay"))
register_htype(HtypeSpec("embedding", default_dtype="float32", ndim=(1,),
                         display="secondary"))
register_htype(HtypeSpec("dicom", default_dtype="int16", ndim=(2, 3),
                         default_codec="zlib", display="primary"))
register_htype(HtypeSpec("tokens", default_dtype="int32", ndim=(1,),
                         display="secondary"))

_META_RE = re.compile(r"^(sequence|link)\[([a-z_0-9\[\]]+)\]$")


def parse_htype(htype: str) -> Tuple[Optional[str], str]:
    """'sequence[image]' -> ('sequence', 'image'); 'image' -> (None, 'image')."""
    htype = (htype or "generic").strip()
    m = _META_RE.match(htype)
    if m:
        meta, base = m.group(1), m.group(2)
        parse_htype(base)  # validate base recursively
        return meta, base
    if htype not in _REGISTRY:
        raise ValueError(f"unknown htype {htype!r}; have {sorted(_REGISTRY)}")
    return None, htype


def get_htype(htype: str) -> HtypeSpec:
    meta, base = parse_htype(htype)
    spec = _REGISTRY[base]
    if meta == "link":
        # links store keys (uint8 strings); payload htype applies post-resolve
        return HtypeSpec(name=f"link[{base}]", default_dtype="uint8", ndim=(1,),
                         default_codec="raw", display=spec.display,
                         extra={"base": base})
    if meta == "sequence":
        # one sample = stack of base samples; ndim = base ndim + 1 where known
        nd = tuple(n + 1 for n in spec.ndim) if spec.ndim else None
        return HtypeSpec(name=f"sequence[{base}]", default_dtype=spec.default_dtype,
                         ndim=nd, default_codec=spec.default_codec,
                         display=spec.display, extra={"base": base})
    return spec


def available_htypes() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
