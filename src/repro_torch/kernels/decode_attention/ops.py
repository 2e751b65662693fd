"""Wrapper for the Hopper decode-attention kernel (inference only: no backward).

``csrc/decode_attention.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into ``build/`` at the
root of the repository, and loaded with ``ctypes``.  Tensors on the CPU go
through the plain version in ``ref.py``; tensors on a CUDA device launch the
kernel, and anything the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import operator
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

from .ref import decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Mirrors of the limits in the CUDA source.
MAX_D = 256
MAX_SPLIT = 1024
BLOCKS_PER_SM = 4      # split blocks to aim for on each SM
MIN_SPLIT_LEN = 32     # keys: below this a split costs more than it saves

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """Where the library built from the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"decode_attention-{digest}.so"


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it.

    The compiler's output, with ``ptxas``'s register and shared-memory counts,
    is kept beside the library as ``.log``.
    """
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.decode_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
    _lib = lib
    return lib


def plan(B: int, H: int, Hkv: int, limit: int, n_sm: int
         ) -> Tuple[int, int, int]:
    """(query heads a block takes, keys a split takes, number of splits).

    A block takes up to 8 query heads of one KV head; the valid length is cut
    into splits so that about ``BLOCKS_PER_SM`` blocks run on each SM, and no
    split has fewer than ``MIN_SPLIT_LEN`` keys unless the whole cache has.
    """
    G = H // Hkv
    gm = 1 if G == 1 else 2 if G == 2 else 4 if G <= 4 else 8
    rows = B * Hkv * -(-G // gm)
    n_split = max(1, min(-(-BLOCKS_PER_SM * n_sm // rows),
                         -(-limit // MIN_SPLIT_LEN), MAX_SPLIT))
    split_len = -(-limit // n_split)
    return gm, split_len, -(-limit // split_len)


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
    if q.device.type == "cpu":
        return decode_attention_ref(q, cache_k, cache_v, pos=pos, window=window)
    if q.device.type != "cuda":
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
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = build()
    limit = min(pos + 1, T)   # both cache rules: idx <= pos, and idx < T
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    gm, split_len, n_split = plan(B, H, Hkv, limit, n_sm)
    out = torch.empty_like(q)
    part_acc = torch.empty((B * H, n_split, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B * H, n_split, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):   # the runtime launches on the current one
        err = lib.decode_attention_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), cache_k.data_ptr(),
            cache_v.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), B, H, Hkv, T, D, limit, gm, split_len, n_split,
            1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
