"""Wrapper for the Hopper decode-attention kernel (inference only: no backward).

``csrc/decode_attention.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, and loaded with
``ctypes`` (``kernels/_build.py``).  bf16 inputs run on the tensor cores
(``mma.sync``), fp32 inputs on the CUDA cores.  Tensors on the CPU go
through the plain version in ``ref.py``; tensors on a CUDA device launch the
kernel, and anything the kernel cannot take raises.

The wrapper is called once per attention layer and token, so what it does on
the host is kept small: the library is loaded and bound once a process, the
card's SM count read once a device, and scratch allocated only when the plan
has more than one split.  A fake tensor (the dry run, ``kernels/_fake.py``),
on any device, takes the kernel's route up to the launch, planned for an
H100's SMs, allocates the same scratch, and reports the call with
:func:`costs` in its place.

:func:`decode_attention_partial` is the same launch over one rank's slice of
a cache split over keys: it also returns each (b, h) row's log-sum-exp, by
which the ranks' slices merge (``distributed.sharding.merge_partials``).
"""

from __future__ import annotations

import ctypes
import math
import operator
from pathlib import Path
from typing import Dict, NamedTuple

import torch

from .. import _build, _fake
from .ref import decode_attention_partial_ref, decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

# Mirrors of the CUDA source's constants (a CPU test parses them).
MAX_D = 256
MAX_SPLIT = 1024
MMA_HEADS = 8          # query heads of one KV head in a bf16 block: an MMA's n
# the bf16 kernel's tiles by head dim: (DP, WARPS, STAGES); a K/V tile holds
# 16 keys a warp, and the ring STAGES tiles
MMA_TILES = ((64, 4, 4), (80, 4, 4), (128, 4, 4), (256, 4, 3))

# The plan's own choices (host only).
SM_SHARED = 228 * 1024   # shared memory of an H100 SM; each block reserves 1 KB
SIMT_BLOCKS_PER_SM = 4   # fp32 blocks to aim for on each SM
MIN_SPLIT_LEN = 64       # keys: below this a split costs more than it saves

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SM_COUNT: Dict[int, int] = {}   # by device index, read once


class Plan(NamedTuple):
    """How one call is cut: ``heads`` query heads a block takes, ``split_len``
    keys a split takes, ``n_split`` splits (each holds a valid key)."""
    heads: int
    split_len: int
    n_split: int

    @property
    def launches(self) -> int:
        """Kernel launches of the call: one split writes the output itself,
        more are merged by a second launch."""
        return 1 if self.n_split == 1 else 2


def library_path() -> Path:
    """Where the library built from the current source lives."""
    return _build.library_path(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it (once per
    process)."""
    return _build.load(SOURCE, _bind)


def mma_tile(D: int) -> tuple:
    """(DP, WARPS, STAGES) of the bf16 kernel at head dim ``D``: the width D
    is padded to, the warps of a block (16 keys each a tile) and the tiles of
    its ring.  Mirrors ``dispatch_mma`` in the CUDA source."""
    if D < 1 or D > MAX_D:
        raise ValueError(f"head dim {D} is not in 1..{MAX_D}")
    return next(tile for tile in MMA_TILES if D <= tile[0])


def mma_smem_bytes(D: int) -> int:
    """Shared memory of one bf16 block at head dim ``D``: the Q rows and the
    K and V rings, rows padded by 16 bytes, or the warps' merge if larger.
    Mirrors ``mma_smem_bytes`` in the CUDA source."""
    DP, warps, stages = mma_tile(D)
    ring = 2 * (MMA_HEADS + 2 * stages * 16 * warps) * (DP + 8)
    return max(ring, 4 * 32 * (warps - 1) * (DP // 4 + 4))


def plan(B: int, H: int, Hkv: int, D: int, limit: int, n_sm: int,
         dtype: torch.dtype = torch.bfloat16) -> Plan:
    """The cut of a call over ``limit`` valid keys on a card of ``n_sm`` SMs.

    A bf16 block takes up to 8 query heads of one KV head (an MMA's n), an
    fp32 block up to 8.  The valid length is cut into splits so that every
    SM holds as many blocks as fit on it (bf16: as its shared memory allows;
    fp32: ``SIMT_BLOCKS_PER_SM``), no split has fewer than ``MIN_SPLIT_LEN``
    keys unless the whole cache has, and, in bf16, a split is a whole number
    of a warp's 16 keys.
    """
    G = H // Hkv
    if dtype == torch.bfloat16:
        heads, align = MMA_HEADS, 16
        per_sm = SM_SHARED // (mma_smem_bytes(D) + 1024)
    else:
        heads, align = (1 if G == 1 else 2 if G == 2 else 4 if G <= 4 else 8), 1
        per_sm = SIMT_BLOCKS_PER_SM
    rows = B * Hkv * -(-G // heads)
    n_split = max(1, min(-(-per_sm * n_sm // rows),
                         -(-limit // MIN_SPLIT_LEN), MAX_SPLIT))
    split_len = -(-limit // n_split)
    split_len = -(-split_len // align) * align
    return Plan(heads, split_len, -(-limit // split_len))


def scratch(p: Plan, B: int, H: int, D: int, device: torch.device):
    """The fp32 partials (acc, (m, l)) a call cut by ``p`` needs: none when
    one split writes the output itself."""
    if p.n_split == 1:
        return None, None
    return (torch.empty((B * H, p.n_split, D), dtype=torch.float32,
                        device=device),
            torch.empty((B * H, p.n_split, 2), dtype=torch.float32,
                        device=device))


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SM_COUNT.get(index)
    if n is None:
        n = _SM_COUNT[index] = \
            torch.cuda.get_device_properties(index).multi_processor_count
    return n


def costs(q, cache_k, limit: int):
    """(operations, bytes) of one call, as its bound counts them: the
    ``limit`` valid keys and values of each KV head read once, q read and
    the output written once; QK^T and PV, 2 each a key, head and dim."""
    B, H, D = q.shape
    Hkv = cache_k.shape[2]
    nbytes = (2 * B * limit * Hkv * D + 2 * B * H * D) * q.element_size()
    return 4 * B * H * limit * D, nbytes


def _check(q, cache_k, cache_v):
    if q.dim() != 3 or cache_k.dim() != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(f"want q (B,H,D) and caches (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(cache_k.shape)}, "
                         f"{tuple(cache_v.shape)}")
    B, H, D = q.shape
    if cache_k.shape[0] != B or cache_k.shape[3] != D or \
            H % cache_k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit caches "
                         f"{tuple(cache_k.shape)}")
    if not (q.device == cache_k.device == cache_v.device):
        raise ValueError("q and the caches lie on different devices")


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, *, pos: int, window: int = 0
                     ) -> torch.Tensor:
    """q (B,H,D); caches (B,T,Hkv,D); pos, a host int -> out (B,H,D).

    On the CPU this is :func:`decode_attention_ref`.  On a CUDA device it
    launches the kernel and adds one to ``decode_attention.launches``.
    """
    pos = operator.index(pos)
    if pos < 0:
        raise ValueError(f"pos must be >= 0, got {pos}")
    _check(q, cache_k, cache_v)
    if q.device.type == "cpu" and not _fake.is_fake(q):
        return decode_attention_ref(q, cache_k, cache_v, pos=pos, window=window)
    # both cache rules: idx <= pos, and idx < T
    return _launch(q, cache_k, cache_v, min(pos + 1, cache_k.shape[1]))


def decode_attention_partial(q: torch.Tensor, k_slice: torch.Tensor,
                             v_slice: torch.Tensor, *, limit: int):
    """q (B,H,D); a slice of the caches (B,T_loc,Hkv,D) whose first ``limit``
    keys are valid (0 <= limit <= T_loc) -> (out (B,H,D) in q's dtype, the
    slice's attention; lse (B,H) fp32, the log-sum-exp of its scaled scores
    in natural units).

    On the CPU this is :func:`decode_attention_partial_ref`.  On a CUDA
    device it launches the kernel, writing ``lse`` beside the output, and
    adds one to ``decode_attention.launches``; with no valid key it launches
    nothing and returns zeros and ``-inf``.
    """
    limit = operator.index(limit)
    _check(q, k_slice, v_slice)
    if not 0 <= limit <= k_slice.shape[1]:
        raise ValueError(f"limit {limit} is not in 0..{k_slice.shape[1]}")
    if q.device.type == "cpu" and not _fake.is_fake(q):
        return decode_attention_partial_ref(q, k_slice, v_slice, limit=limit)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if limit == 0:
        return torch.zeros_like(q), lse.fill_(-math.inf)
    return _launch(q, k_slice, v_slice, limit, lse), lse


def _launch(q, cache_k, cache_v, limit: int, lse=None) -> torch.Tensor:
    """The kernel over the first ``limit`` keys (>= 1) of the caches, on a
    CUDA device (or reported, for a fake tensor); ``lse`` (B,H) fp32, if
    given, takes each row's log-sum-exp."""
    fake = _fake.is_fake(q)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"no decode attention for device {q.device}")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == cache_k.dtype
                                          == cache_v.dtype):
        raise ValueError(f"want fp32 or bf16 throughout; got {q.dtype}, "
                         f"{cache_k.dtype}, {cache_v.dtype}")
    B, H, D = q.shape
    T, Hkv = cache_k.shape[1], cache_k.shape[2]
    if D % 8 or D > MAX_D:
        raise ValueError(f"head dim {D} is not a multiple of 8 up to {MAX_D}")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v)):
        if not t.is_contiguous() or (not fake and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if fake:
        from repro_torch.launch.mesh import H100
        n_sm = H100["sm_count"]
    else:
        lib = build()
        n_sm = _sm_count(q.device)
    p = plan(B, H, Hkv, D, limit, n_sm, q.dtype)
    out = torch.empty_like(q)
    part_acc, part_ml = scratch(p, B, H, D, q.device)
    if fake:
        _fake.call("decode_attention", *costs(q, cache_k, limit), q.dtype)
        return out
    with torch.cuda.device(q.device):   # the runtime launches on the current one
        err = lib.decode_attention_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), cache_k.data_ptr(),
            cache_v.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, H, Hkv, T, D, limit, p.heads, p.split_len, p.n_split,
            1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
