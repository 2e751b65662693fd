"""AdamW with global-norm clipping and configurable moment dtype (port of
``repro.optim.adamw``).

State is a plain dict ({"step", "m", "v"}) with the JAX package's structure,
so checkpoints carry over between the two packages: ``step`` is an int32
scalar tensor, ``m`` and ``v`` mirror the parameter tree in the moment dtype.

``update`` writes the new moments into the state's tensors IN PLACE and
returns the same state dict, as the JAX trainer donates its state to the
step: at full width the moments are 8 bytes a parameter, and a second copy
would not fit beside the first.  ``apply_updates`` adds in place too.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.param import (ParamSpec, named_leaves, torch_dtype,
                                      tree_map, unflatten)


@dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"

    def init(self, params) -> Dict[str, Any]:
        dt = torch_dtype(self.moment_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        device = next(t for _, t in named_leaves(params)).device
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def state_specs(self, param_specs) -> Dict[str, Any]:
        """ParamSpec tree for the optimizer state (checkpoint restore)."""
        remap = lambda s: ParamSpec(s.shape, s.axes, init="zeros",
                                    dtype=self.moment_dtype)
        return {"step": ParamSpec((), (), init="zeros", dtype="int32"),
                "m": tree_map(remap, param_specs),
                "v": tree_map(remap, param_specs)}

    @torch.no_grad()
    def update(self, grads, state: Dict[str, Any], params
               ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0) if self.clip_norm else 1.0
        stepf = step.float()
        bc1 = 1 - torch.pow(self.b1, stepf)
        bc2 = 1 - torch.pow(self.b2, stepf)
        lr = self.learning_rate(step)

        def upd(g, m, v, p):
            gf = g.float() * scale
            m_new = self.b1 * m.float() + (1 - self.b1) * gf
            v_new = self.b2 * v.float() + (1 - self.b2) * gf * gf
            delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + self.eps)
            if self.weight_decay and p.dim() >= 2:   # no decay on norms/scalars
                delta = delta + self.weight_decay * p.float()
            m.copy_(m_new)
            v.copy_(v_new)
            return (-lr * delta).to(p.dtype)

        updates = unflatten(
            (path, upd(g, m, v, p)) for (path, g), (_, m), (_, v), (_, p) in zip(
                named_leaves(grads), named_leaves(state["m"]),
                named_leaves(state["v"]), named_leaves(params)))
        state["step"] = step
        return updates, state, {"grad_norm": gnorm}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for _, l in named_leaves(tree)))


@torch.no_grad()
def apply_updates(params, updates):
    """params + updates, written into ``params``' tensors."""
    return tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr
