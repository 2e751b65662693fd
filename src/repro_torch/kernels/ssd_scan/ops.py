"""Wrapper for the Hopper SSD chunked-scan kernels, with the gradient.

``csrc/ssd_scan.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, and loaded with ``ctypes``
(``kernels/_build.py``).  It has two routes: bf16 inputs run four
chunk-parallel passes on the tensor cores (chunk state, C·Bᵀ once per group,
state passing, chunk scan), reading x, B and C through their own strides;
fp32 inputs run one CUDA-core kernel on contiguous tensors.

``ssd`` is a ``torch.autograd.Function``, as the JAX package's is a
``custom_vjp``: its forward is a kernel route on a CUDA tensor and
``ssd_chunked`` on a CPU tensor; its backward recomputes through
``ssd_chunked`` under autograd, exactly as the JAX backward does (there is no
backward kernel in either package).  A CUDA tensor no route can take
raises; nothing falls back.  A fake tensor (the dry run,
``kernels/_fake.py``), on any device, takes the kernel's route up to the
launch, allocates the same outputs and scratch, and reports the call with
:func:`costs` in its place.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.models.ssm import _chunk_len, ssd_chunked

from .. import _build, _fake

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
# Mirrors of the CUDA source's constants (a CPU test parses them).
MAX_N = 128
MAX_P = 64
MAX_Q = 1024
TILE = 64            # kMT: tokens (or state rows) of a tile
MMA_THREADS = 128    # passes 1 and 4: 4 warps of 16 rows
CB_ROWS = 32         # pass 2: rows of C·Bᵀ a block computes
CB_THREADS = 64      # pass 2: 2 warps of 16 rows
PASS_THREADS = 256   # pass 3: 4 state entries a thread
BF16_BYTES, FP32_BYTES = 2, 4


def library_path() -> Path:
    """Where the library built from the current source lives."""
    return _build.library_path(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.ssd_scan_launch
    fn.restype = i32
    fn.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
    fn = lib.ssd_scan_mma_launch
    fn.restype = i32
    fn.argtypes = ([ptr, i64, i64, i64, ptr, ptr, ptr, i64, i64, i64,
                    ptr, i64, i64, i64] + [ptr] * 5 + [i32] * 7 + [ptr])


def build() -> ctypes.CDLL:
    """Compile the kernels (once per source version) and load them (once per
    process)."""
    return _build.load(SOURCE, _bind)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def state_rows(N: int) -> int:
    """State rows a chunk-state block computes: all of them up to 128."""
    return 2 * TILE if _round_up(N, 16) > TILE else TILE


def smem_bytes(N: int, P: int, Q: int) -> Dict[str, int]:
    """Dynamic shared memory of each bf16 pass, as the source sizes it."""
    NP, PP, LQ = _round_up(N, 16), _round_up(P, 16), _round_up(Q, TILE)
    return {
        "chunk_state": (2 * TILE * ((state_rows(N) + 8) + (PP + 8))
                        * BF16_BYTES + 2 * LQ * FP32_BYTES),
        "chunk_cb": (CB_ROWS + TILE) * (NP + 8) * BF16_BYTES,
        "state_pass": 0,
        "chunk_scan": ((TILE * (NP + 8) + (max(2 * NP, TILE) + TILE)
                        * (PP + 8)) * BF16_BYTES + 2 * LQ * FP32_BYTES),
    }


def grids(B: int, S: int, nh: int, P: int, G: int, N: int, Q: int
          ) -> Dict[str, int]:
    """Blocks each bf16 pass launches."""
    nc, nT = S // Q, _round_up(Q, TILE) // TILE
    NP = _round_up(N, 16)
    return {
        "chunk_state": B * nc * nh * -(-NP // state_rows(N)),
        "chunk_cb": nT * (nT + 1) * nc * G * B,
        "state_pass": B * nh * -(-(N * P // 4) // PASS_THREADS),
        "chunk_scan": B * nc * nh * nT,
    }


def scratch_shapes(B: int, S: int, nh: int, P: int, G: int, N: int, Q: int
                   ) -> Dict[str, Tuple[int, ...]]:
    """The bf16 passes' fp32 scratch: each chunk's state (then the state
    before it), C·Bᵀ of each chunk and group, and a_cum."""
    nc, LQ = S // Q, _round_up(Q, TILE)
    return {"states": (B, nc, nh, N, P), "cb": (B, nc, G, LQ, LQ),
            "acum": (B, nh, S)}


def costs(x, Bm, Q: int):
    """(operations, bytes) of one call, as its bound counts them:
    Q(Q+1)(N+P) + 4QNP operations for each (batch, head, chunk); x, dt, A,
    B and C read once, y and the fp32 final state written once."""
    B, S, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    ops = B * nh * (S // Q) * (Q * (Q + 1) * (N + P) + 4 * Q * N * P)
    item = x.element_size()
    nbytes = (2 * B * S * nh * P * item + B * S * nh * 4
              + 2 * B * S * G * N * item + B * nh * N * P * 4 + nh * 4)
    return ops, nbytes


def _strided(t: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """A (B, S, heads, D) tensor as the bf16 passes read it: itself and its
    batch, token and head strides, as long as its last dimension is
    contiguous (a view of a wider row, such as mamba2's conv output, is not
    copied); otherwise a contiguous copy."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        t = t.contiguous()
    return t, (t.stride(0), t.stride(1), t.stride(2))


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


def _kernel_forward(x, dt, A, Bm, Cm, Q: int, fake: bool = False):
    """Launch a route on one CUDA device -> y (B,S,nh,P), state fp32; for
    ``fake`` tensors, report the call instead."""
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            not (x.dtype == Bm.dtype == Cm.dtype):
        raise ValueError(f"want x, B and C all fp32 or all bf16; got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"want dt and A in fp32; got {dt.dtype}, {A.dtype}")
    B, S, nh, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if N % 4 or N > MAX_N or P > MAX_P or Q > MAX_Q:
        raise ValueError(f"unsupported N={N} (a multiple of 4 up to {MAX_N}),"
                         f" P={P} (up to {MAX_P}) or chunk {Q} (up to {MAX_Q})")
    lib = None if fake else build()
    dt, A = dt.contiguous(), A.contiguous()
    dev = x.device
    y = torch.empty((B, S, nh, P), dtype=x.dtype, device=dev)
    state = torch.empty((B, nh, N, P), dtype=torch.float32, device=dev)
    if x.dtype == torch.float32:
        x, Bm, Cm = x.contiguous(), Bm.contiguous(), Cm.contiguous()
    else:
        (x, xs), (Bm, bs), (Cm, cs) = (_strided(t) for t in (x, Bm, Cm))
        scratch = {name: torch.empty(shape, dtype=torch.float32, device=dev)
                   for name, shape in scratch_shapes(B, S, nh, P, G, N,
                                                     Q).items()}
    if fake:
        _fake.call("ssd_scan", *costs(x, Bm, Q), x.dtype)
        return y, state
    with torch.cuda.device(dev):   # the runtime launches on the current one
        stream = torch.cuda.current_stream(dev).cuda_stream
        if x.dtype == torch.float32:
            err = lib.ssd_scan_launch(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
                B, S, nh, P, G, N, Q, stream)
        else:
            err = lib.ssd_scan_mma_launch(
                x.data_ptr(), *xs, dt.data_ptr(), A.data_ptr(),
                Bm.data_ptr(), *bs, Cm.data_ptr(), *cs, y.data_ptr(),
                state.data_ptr(), scratch["states"].data_ptr(),
                scratch["cb"].data_ptr(), scratch["acum"].data_ptr(),
                B, S, nh, P, G, N, Q, stream)
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
        if _fake.is_fake(x):
            return _kernel_forward(x, dt, A, Bm, Cm, Q, fake=True)
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
    launches a kernel route (bf16: four passes; fp32: one kernel) and adds
    one to ``ssd.launches``.
    """
    Q = _check(x, dt, A, Bm, Cm, chunk)
    return _SSD.apply(x, dt, A, Bm, Cm, int(chunk), Q)


ssd.launches = 0
