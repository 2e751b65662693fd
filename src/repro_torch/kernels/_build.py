"""Build a kernel's CUDA source with ``nvcc`` and load it with ``ctypes``.

Each kernel is one ``.cu`` file with a plain C interface, compiled for
``sm_90a`` at first use into ``build/`` at the root of the repository.  The
library's name carries a digest of the source and the flags, so an edited
source builds anew.  The compiler's output, with ``ptxas``'s register,
shared-memory and spill counts, is kept beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` as it is now lives."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}-{digest}.so"


def load(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per version) and load it; raises on failure."""
    so = library_path(source)
    if so in _loaded:
        return _loaded[so]
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    _loaded[so] = ctypes.CDLL(str(so))
    return _loaded[so]
