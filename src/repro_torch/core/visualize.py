"""Visualizer engine, server side (§4.2).

The paper's in-browser WebAssembly renderer cannot exist in this container;
what *is* reproducible is the htype-aware layout logic it depends on: decide
which tensors are primary (image/video/audio), which overlay (bbox/mask/
class_label), group by name prefix, and support sequence scrubbing without
fetching whole samples (per-frame region reads).  ``render_ascii`` gives a
terminal rendering used by the examples.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .htypes import get_htype


@dataclass
class LayoutPanel:
    primary: str
    overlays: List[str] = field(default_factory=list)
    secondary: List[str] = field(default_factory=list)


def plan_layout(ds) -> List[LayoutPanel]:
    """Group tensors into visualization panels by display role + group prefix."""
    roles: Dict[str, str] = {}
    for name, t in ds.tensors.items():
        roles[name] = get_htype(t.meta.htype).display
    primaries = [n for n, r in roles.items() if r == "primary"]
    panels = []
    for p in sorted(primaries):
        prefix = p.rsplit("/", 1)[0] + "/" if "/" in p else ""
        panel = LayoutPanel(primary=p)
        for n, r in sorted(roles.items()):
            if n == p:
                continue
            same_group = (n.startswith(prefix) if prefix else "/" not in n)
            if r == "overlay" and same_group:
                panel.overlays.append(n)
            elif r == "secondary" and same_group:
                panel.secondary.append(n)
        panels.append(panel)
    if not panels:  # tabular-only dataset: one panel of secondaries
        panels.append(LayoutPanel(primary="", secondary=sorted(roles)))
    return panels


def frame_of_sequence(ds, tensor: str, idx: int, frame: int) -> np.ndarray:
    """Jump to one frame of a sequence[...] sample without fetching the rest
    (§4.2 'jump to the specific position of the sequence')."""
    t = ds[tensor]
    if not t.is_sequence:
        raise TypeError(f"{tensor} is not a sequence htype")
    return t.read_region(idx, (slice(frame, frame + 1),))[0]


_RAMP = " .:-=+*#%@"


def _ascii_image(img: np.ndarray, width: int = 48) -> str:
    if img.ndim == 3:
        img = img.mean(axis=-1)
    h, w = img.shape
    step = max(1, w // width)
    rows = []
    for y in range(0, h, step * 2):
        row = ""
        for x in range(0, w, step):
            v = float(img[y, x]) / max(float(img.max()), 1.0)
            row += _RAMP[min(int(v * (len(_RAMP) - 1)), len(_RAMP) - 1)]
        rows.append(row)
    return "\n".join(rows)


def render_ascii(ds, idx: int, width: int = 48) -> str:
    """Terminal rendering of one row following the planned layout."""
    out = []
    for panel in plan_layout(ds):
        if panel.primary:
            arr = ds[panel.primary].read(idx)
            out.append(f"┌─ {panel.primary} {arr.shape} {arr.dtype}")
            if arr.ndim in (2, 3):
                out.append(_ascii_image(arr, width))
        for name in panel.overlays + panel.secondary:
            t = ds[name]
            if idx >= len(t):
                continue
            v = t.read(idx)
            if t.meta.htype == "text":
                out.append(f"│ {name} = {v.tobytes().decode(errors='replace')!r}")
            elif v.size <= 8:
                out.append(f"│ {name} = {np.array2string(v, precision=2)}")
            else:
                out.append(f"│ {name}: shape={v.shape} mean={v.mean():.3f}")
    return "\n".join(out)
