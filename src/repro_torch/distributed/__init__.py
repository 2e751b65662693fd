"""Distributed-training utilities (port of ``repro.distributed``).

``fault_tolerance`` is dependency-free and imported eagerly — the lake's
fetch engine reuses its :class:`StragglerDetector` as the hedge trigger for
prefetches.  The mesh rules (``sharding``) and the int8 all-reduce
(``collectives``) load on first attribute access, as in the JAX package, so
that pure-I/O paths load neither the models nor ``torch.distributed``.
"""

from .fault_tolerance import (FailureInjector, HostFailure, StragglerDetector,
                              run_resilient)

_COLLECTIVES = {"collective_wire_bytes", "make_quantized_allreduce",
                "quantized_psum"}
_SHARDING = {"axis_size", "batch_specs", "distribute", "fit_spec",
             "make_rules", "make_shard_fn", "mesh_axis_names", "mesh_sizes",
             "place_tree", "placements_for", "pspec_for_specs",
             "shard_groups", "shard_of", "sharding_for_specs", "spec_for"}

__all__ = ["FailureInjector", "HostFailure", "StragglerDetector",
           "run_resilient"] + sorted(_COLLECTIVES | _SHARDING)


def __getattr__(name):
    if name in _COLLECTIVES:
        from . import collectives
        return getattr(collectives, name)
    if name in _SHARDING:
        from . import sharding
        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
