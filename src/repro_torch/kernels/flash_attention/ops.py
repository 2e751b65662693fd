"""Wrapper for the Hopper flash-attention forward kernel, with its gradient.

``csrc/flash_attention.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, and loaded with
``ctypes`` (``kernels/_build.py``).

``flash_attention`` is a ``torch.autograd.Function``, as the JAX package's is
a ``custom_vjp``: its forward is the kernel on a CUDA tensor and the plain
version (``ref.py``) on a CPU tensor; its backward recomputes attention
through ``ref_attention`` under autograd, exactly as the JAX backward does
(there is no backward kernel in either package yet).  A CUDA tensor the
kernel cannot take raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from .. import _build
from .ref import ref_attention

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_D = 256                 # mirrors kMaxD in the CUDA source
MAX_GRID_YZ = 65535         # H and B are the grid's y and z

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def library_path() -> Path:
    """Where the library built from the current source lives."""
    return _build.library_path(SOURCE)


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it."""
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,S,H,D) and k/v (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def _kernel_forward(q, k, v, causal: bool, window: int, scale: float):
    """Launch the kernel: q (B,S,H,D), k/v (B,T,Hkv,D) on one CUDA device."""
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"want fp32 or bf16 throughout; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if D % 8 or D > MAX_D:
        raise ValueError(f"head dim {D} is not a multiple of 8 up to {MAX_D}")
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ or window < 0:
        raise ValueError(f"unsupported B={B}, H={H}, window={window}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = build()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):   # the runtime launches on the current one
        err = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, T, H, Hkv, D, int(causal), window, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        if q.device.type == "cpu":
            return ref_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
        if q.device.type != "cuda":
            raise ValueError(f"no flash attention for device {q.device}")
        return _kernel_forward(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.args
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref_attention(q, k, v, causal=causal, window=window,
                                scale=scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,Hkv,D) -> (B,S,H,D), differentiable.

    On the CPU the forward is :func:`ref_attention`.  On a CUDA device it
    launches the kernel and adds one to ``flash_attention.launches``.
    """
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 float(scale))


flash_attention.launches = 0
