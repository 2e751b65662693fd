"""Wrapper for the Hopper crop-normalize kernel (data path: no gradient).

``csrc/fused_preprocess.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, and loaded with
``ctypes`` (``kernels/_build.py``).  Tensors on the CPU go through the plain
version in ``ref.py``; tensors on a CUDA device launch the kernel on the
current stream, and anything the kernel cannot take raises.  A fake tensor
(the dry run, ``kernels/_fake.py``), on any device, takes the kernel's route
up to the launch and reports the call with :func:`costs` in its place.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence, Tuple

import torch

from .. import _build, _fake
from .ref import ref_preprocess

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_preprocess.cu"
# mirrors of the CUDA source's constants (a CPU test reads the source)
MAX_C = 64          # kMaxC: the most channels the kernel takes
TABLE_C = 4         # kTableC: up to here a table in shared memory, no division
TABLE_STRIDE = 264  # kStride: table floats between two channels
QUADS = 4           # kQuads: quads of 4 output elements a thread takes a pass
THREADS = 256       # kThreads
MAX_EXTENT = 2 ** 29  # the window's h and its row's w*C stay below this


def library_path() -> Path:
    """Where the library built from the current source lives."""
    return _build.library_path(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fused_preprocess_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])


def build() -> ctypes.CDLL:
    """Compile the kernel (once per source version) and load it (once per
    process)."""
    return _build.load(SOURCE, _bind)


def costs(out: torch.Tensor):
    """(operations, bytes) of one call, as its bound counts them: the
    window's uint8 read and the fp32 output written once; a subtract and
    two products an element."""
    n = out.numel()
    return 3 * n, n * (1 + 4)


def fused_preprocess(images: torch.Tensor, crop: Tuple[int, int, int, int],
                     mean: Sequence[float], std: Sequence[float]
                     ) -> torch.Tensor:
    """images (B,H,W,C) uint8; crop (y0, x0, h, w) -> (B,h,w,C) float32,
    ``(x / 255 - mean[c]) / std[c]`` over the crop window.

    On the CPU this is :func:`ref_preprocess`.  On a CUDA device it launches
    the kernel, reading the window in place, and adds one to
    ``fused_preprocess.launches``; an empty output launches nothing.
    """
    if images.dim() != 4:
        raise ValueError(f"want images (B,H,W,C); got {tuple(images.shape)}")
    B, H, W, C = images.shape
    y0, x0, h, w = (int(v) for v in crop)
    if not (0 <= y0 and y0 + h <= H and 0 <= x0 and x0 + w <= W):
        raise ValueError(f"crop {tuple(crop)} leaves images of shape "
                         f"{tuple(images.shape)}")
    mean, std = [float(v) for v in mean], [float(v) for v in std]
    if len(mean) != C or len(std) != C:
        raise ValueError(f"want {C} means and stds; got {len(mean)} and "
                         f"{len(std)}")
    fake = _fake.is_fake(images)
    if images.device.type == "cpu" and not fake:
        return ref_preprocess(images, (y0, x0, h, w), mean, std)
    if images.device.type != "cuda" and not fake:
        raise ValueError(f"no fused preprocess for device {images.device}")
    if images.dtype != torch.uint8 or not images.is_contiguous():
        raise ValueError(f"want contiguous uint8 images; got {images.dtype}"
                         f"{'' if images.is_contiguous() else ', strided'}")
    if C > MAX_C or w * C >= MAX_EXTENT or h >= MAX_EXTENT:
        raise ValueError(f"unsupported C={C} (up to {MAX_C}) or crop of {h} "
                         f"rows of {w * C} elements (each below {MAX_EXTENT})")
    out = torch.empty((B, h, w, C), dtype=torch.float32, device=images.device)
    if out.numel() == 0:
        return out
    if fake:
        _fake.call("fused_preprocess", *costs(out), torch.float32)
        return out
    lib = build()
    mean_c, std_c = (ctypes.c_float * C)(*mean), (ctypes.c_float * C)(*std)
    with torch.cuda.device(images.device):  # the runtime launches on the current one
        err = lib.fused_preprocess_launch(
            images.data_ptr(), out.data_ptr(),
            ctypes.addressof(mean_c), ctypes.addressof(std_c),
            B, H, W, C, y0, x0, h, w,
            torch.cuda.current_stream(images.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_preprocess launch failed: CUDA error {err}")
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0
