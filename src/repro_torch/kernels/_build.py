"""Build hand-written CUDA kernels into shared libraries, loaded by ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` at first use.  The library lands in
``build/kernels/`` at the repository root, named by a hash of its
source, so a changed source rebuilds and an unchanged one loads as is.
A failed build raises; nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source at first use")
    return nvcc


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives (keyed by content)."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{source.stem}-{digest[:16]}.so"


def compile_source(source: Path) -> Path:
    """Compile ``source`` unless its library already exists; returns the
    library path.  ``ptxas``'s resource report (registers, stack frame,
    spills per kernel) is kept beside it with the suffix ``.log``.
    Raises RuntimeError with nvcc's output on failure."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of ``source``, building it on first use."""
    with _LOCK:
        path = compile_source(source)
        lib = _LOADED.get(path)
        if lib is None:
            lib = _LOADED[path] = ctypes.CDLL(str(path))
        return lib
