"""Build and load the port's CUDA kernels.

Each source in ``repro_torch/csrc`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``build/kernels/`` of the checkout (listed in ``.gitignore``), keyed by a
hash of the source and the flags; it is loaded with ``ctypes``.  Nothing is
built or loaded when a module is imported.

Every failure to build, load or launch one of these kernels raises
:class:`KernelError`, which the runtime never demotes around, swallows or
retries (``core/resilience.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# No --use_fast_math: sqrtf and division stay IEEE.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch."""


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise KernelError("nvcc not found: the port's kernels are built on a "
                      "machine with the CUDA toolkit")


def library_path(source: Path) -> Path:
    """Where the built library for the current ``source`` lives."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{source.stem}_{digest}.so"


def build(source: Path) -> tuple[Path, float, str]:
    """Compile ``source`` unless it is already built.  Returns
    ``(path, seconds, compiler log)``; seconds is 0.0 for a cached build."""
    path = library_path(source)
    if path.is_file():
        return path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                              f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path, time.perf_counter() - t0, proc.stdout + proc.stderr


def load(source: Path, configure: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source``, built if needed; ``configure``
    declares its entry points (and may check its ABI) once, on first load.
    A library that will not load raises ``KernelError``."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path, _secs, _log = build(source)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path.name}: {e}") from e
            configure(lib)
            _libs[source] = lib
        return lib
