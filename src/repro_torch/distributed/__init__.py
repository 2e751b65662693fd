"""Distributed-training utilities (the port's copy of ``repro.distributed``'s
dependency-free parts).

``fault_tolerance`` is a copy of the JAX package's module; ``sharding`` holds
only the work partitioners that the lake's serving tier uses.  The mesh
sharding rules and collectives come with the distribution slice (ROADMAP
Queue 1 item 16).
"""

from .fault_tolerance import (FailureInjector, HostFailure, StragglerDetector,
                              run_resilient)
from .sharding import shard_groups, shard_of

__all__ = ["FailureInjector", "HostFailure", "StragglerDetector",
           "run_resilient", "shard_groups", "shard_of"]
