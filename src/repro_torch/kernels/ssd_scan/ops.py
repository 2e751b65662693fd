"""Wrapper for the Hopper SSD chunked-scan kernel, with its gradient.

``csrc/ssd_scan.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, and loaded with ``ctypes``
(``kernels/_build.py``).

``ssd`` is a ``torch.autograd.Function``, as the JAX package's is a
``custom_vjp``: its forward is the kernel on a CUDA tensor and
``ssd_chunked`` on a CPU tensor; its backward recomputes through
``ssd_chunked`` under autograd, exactly as the JAX backward does (there is no
backward kernel in either package).  A CUDA tensor the kernel cannot take
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.models.ssm import _chunk_len, ssd_chunked

from .. import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
# mirrors of the limits in the CUDA source
MAX_N = 128
MAX_P = 64
MAX_Q = 1024

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def library_path() -> Path:
    """Where the library built from the current source lives."""
    return _build.library_path(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it (once per
    process)."""
    return _build.load(SOURCE, _bind)


def _check(x, dt, A, Bm, Cm, chunk: int) -> int:
    """The shapes the function takes; returns the chunk length Q."""
    if x.dim() != 4 or Bm.dim() != 4 or Bm.shape != Cm.shape:
        raise ValueError(f"want x (B,S,nh,P) and B/C (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, S, nh, _ = x.shape
    G = Bm.shape[2]
    if dt.shape != (B, S, nh) or A.shape != (nh,) or Bm.shape[:2] != (B, S) \
            or nh % G:
        raise ValueError(f"x {tuple(x.shape)} does not fit dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B/C "
                         f"{tuple(Bm.shape)}")
    if not (x.device == dt.device == A.device == Bm.device == Cm.device):
        raise ValueError("the inputs lie on different devices")
    return _chunk_len(S, chunk)


def _kernel_forward(x, dt, A, Bm, Cm, Q: int):
    """Launch the kernel on one CUDA device -> y (B,S,nh,P), state fp32."""
    if x.dtype not in _DTYPE_CODE or not (x.dtype == Bm.dtype == Cm.dtype):
        raise ValueError(f"want x, B and C all fp32 or all bf16; got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"want dt and A in fp32; got {dt.dtype}, {A.dtype}")
    B, S, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if N % 4 or N > MAX_N or P > MAX_P or Q > MAX_Q:
        raise ValueError(f"unsupported N={N} (a multiple of 4 up to {MAX_N}),"
                         f" P={P} (up to {MAX_P}) or chunk {Q} (up to {MAX_Q})")
    x, dt, A, Bm, Cm = (t.contiguous() for t in (x, dt, A, Bm, Cm))
    lib = build()
    y = torch.empty_like(x)
    state = torch.empty((B, nh, N, P), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):   # the runtime launches on the current one
        err = lib.ssd_scan_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            B, S, nh, P, G, N, Q,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd.launches += 1
    return y, state


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, Q):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            return ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk)
        if x.device.type != "cuda":
            raise ValueError(f"no ssd scan for device {x.device}")
        return _kernel_forward(x, dt, A, Bm, Cm, Q)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = ssd_chunked(*inputs, chunk=ctx.chunk)
        # an output that took no part in the loss brings None: zeros, as in JAX
        gy = torch.zeros_like(y) if gy is None else gy
        gstate = torch.zeros_like(state) if gstate is None else gstate
        grads = torch.autograd.grad((y, state), inputs, (gy, gstate))
        return (*grads, None, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 256):
    """x (B,S,nh,P), dt (B,S,nh), A (nh,), Bm/Cm (B,S,G,N)
    -> y (B,S,nh,P), final_state (B,nh,N,P) fp32; differentiable.

    On the CPU the forward is :func:`ssd_chunked`.  On a CUDA device it
    launches the kernel and adds one to ``ssd.launches``.
    """
    Q = _check(x, dt, A, Bm, Cm, chunk)
    return _SSD.apply(x, dt, A, Bm, Cm, int(chunk), Q)


ssd.launches = 0
