"""What a kernel wrapper does with a fake tensor: the dry run's hook.

The dry run (``launch/dryrun.py``) runs the port's real step on
``FakeTensor``s, which have shapes and dtypes but no data.  A wrapper handed
one takes its kernel's route, whatever the fake tensor's device: it checks
what the kernel would check, allocates the outputs and the scratch the
launch would use, and reports the call here, with the operations and bytes
its kernel's bound counts, in place of building and launching it: every
active dispatch mode with a ``kernel_call`` method (the counters of
``launch/op_analysis.py``) hears of it.  A launch counter
(``flash_attention.launches``, ...) counts only real launches.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def is_fake(t: torch.Tensor) -> bool:
    return isinstance(t, FakeTensor)


def call(name: str, flops: float, nbytes: float, dtype: torch.dtype) -> None:
    """One kernel call of ``flops`` operations in ``dtype`` that moves
    ``nbytes`` of device memory, told to every active counter."""
    # a mode entered twice (as a counter is, to decompose an op) hears once
    for mode in {id(m): m for m in _get_current_dispatch_mode_stack()
                 }.values():
        report = getattr(mode, "kernel_call", None)
        if report is not None:
            report(name, flops, nbytes, dtype)
