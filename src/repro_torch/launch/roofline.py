"""Roofline terms of a dry-run cell on H100 figures (port of
``repro.launch.roofline``: ``Roofline``, ``model_flops``,
``active_param_count``).

Three terms per (arch x shape x mesh), in seconds, from one device's counts
(``launch/op_analysis.py``):

    compute    = sum over dtypes of flops / that dtype's peak (fp32 at the
                 CUDA cores' rate: the port keeps TF32 off)
    memory     = hbm_bytes / HBM rate
    collective = 2 x (bytes on groups inside a node / NVLink rate
                      + bytes on groups across nodes / InfiniBand rate)

the factor 2 being JAX's ring factor (an all-reduce moves about twice its
payload).  The figures are ``launch/mesh.py::H100``.  JAX's
``collective_stats`` and ``extract_cost`` read XLA's HLO text and its
compiled executable; the port has neither, and ``op_analysis`` counts
collectives as they are dispatched, so they have no counterpart here.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict

from .mesh import H100


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collective_breakdown: Dict[str, int]
    peak_memory_per_device: float
    model_flops_total: float
    # flops by dtype name; empty: all of ``flops_per_device`` in bf16
    flops_by_dtype: Dict[str, float] = field(default_factory=dict)
    # the part of ``collective_bytes`` on groups that span nodes
    collective_bytes_across_nodes: float = 0.0

    @property
    def compute_s(self) -> float:
        by_dtype = self.flops_by_dtype or {"bfloat16": self.flops_per_device}
        peaks = H100["peak_flops"]
        return sum(f / peaks.get(dt, peaks["bfloat16"])
                   for dt, f in by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / H100["hbm_bw"]

    @property
    def collective_s(self) -> float:
        across = self.collective_bytes_across_nodes
        inside = self.collective_bytes - across
        return 2.0 * (inside / H100["nvlink_bw"] + across / H100["ib_bw"])

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        denom = self.flops_per_device * self.chips
        return (self.model_flops_total / denom) if denom else 0.0

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / achievable step time (higher = closer to
        the compute roofline)."""
        useful_s = ((self.model_flops_total / self.chips)
                    / H100["peak_flops"]["bfloat16"])
        return useful_s / self.bound_s if self.bound_s else 0.0

    def to_json(self) -> dict:
        d = asdict(self)
        for k in ("compute_s", "memory_s", "collective_s", "dominant",
                  "useful_flops_ratio", "roofline_fraction", "bound_s"):
            d[k] = getattr(self, k)
        return d


def model_flops(cfg, shape_cfg, n_params: int) -> float:
    """6·N·D (train) / 2·N·D (forward-only prefill) / 2·N per decoded token."""
    if shape_cfg.kind == "train":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 6.0 * n_params * tokens
    if shape_cfg.kind == "prefill":
        tokens = shape_cfg.global_batch * shape_cfg.seq_len
        return 2.0 * n_params * tokens
    return 2.0 * n_params * shape_cfg.global_batch   # one token / sequence


def active_param_count(cfg, model) -> int:
    """N for MODEL_FLOPS: MoE counts only activated experts (6·N_active·D)."""
    from repro_torch.models.param import count_params
    total = count_params(model.param_specs())
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe_layers = cfg.num_layers - m.first_dense_layers
    per_expert = 3 * cfg.d_model * m.d_expert
    inactive = n_moe_layers * (m.num_experts - m.top_k) * per_expert
    return total - inactive
