"""Build a kernel's CUDA source with ``nvcc`` and load it with ``ctypes``.

Each kernel is one ``.cu`` file with a plain C interface, compiled for
``sm_90a`` at first use into ``build/`` at the root of the repository.  The
library's name carries a digest of the source and the flags, so an edited
source builds anew in a new process.  Within a process a source is hashed,
built and loaded once: every later :func:`load` is a dictionary lookup, since
a wrapper calls it on every launch.  The compiler's output, with ``ptxas``'s
register, shared-memory and spill counts, is kept beside the library as
``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[Path, ctypes.CDLL] = {}   # by source: loaded once a process


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


def load(source: Path,
         bind: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """The library built from ``source``: compiled (once per version) and
    loaded on the first call in this process, which also runs ``bind`` on it
    (to declare its functions' ``argtypes``); from the cache after that,
    without reading the source.  Raises if the build fails."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    so = library_path(source)
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
    lib = ctypes.CDLL(str(so))
    if bind is not None:
        bind(lib)
    _loaded[source] = lib
    return lib
