"""Build the hand-written CUDA kernels with plain nvcc and load them with ctypes.

Each source in ``s2r_tpu_torch/csrc/<name>.cu`` exposes a C interface (raw
pointers, int64 sizes, a ``cudaStream_t``) and compiles on its own into
``s2r_tpu_torch/_build/<name>-<hash>.so``, where the hash covers the source
and the flags, so an edited source builds anew and an unchanged one is
reused.  The build directory is the only place the package writes, and git
ignores it.  Nothing here runs at import time: a kernel is built at its first
use, or ahead of time by ``build_all``, which starts one nvcc per source at
once.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("depthwise", "requant")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if absent."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


class _Build:
    """One nvcc process writing `so` through a temporary file."""

    def __init__(self, name: str, so: Path):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.so = so
        self.tmp = so.with_suffix(f".{os.getpid()}.tmp")
        self.cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(self.tmp),
                    str(SRC_DIR / f"{name}.cu")]
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(self) -> None:
        out, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({self.proc.returncode}): "
                               f"{' '.join(self.cmd)}\n{out}")
        os.replace(self.tmp, self.so)  # atomic: no reader sees half a file

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.tmp.unlink(missing_ok=True)


def build_all(names: Iterable[str] = SOURCES) -> List[Path]:
    """Build every named kernel not yet built, one nvcc each, all at once."""
    targets = [(n, _target(n)) for n in names]
    builds = [_Build(n, so) for n, so in targets if not so.exists()]
    try:
        for b in builds:
            b.finish()
    finally:
        for b in builds:
            b.kill()
    return [so for _, so in targets]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = _target(name)
            if not so.exists():
                build_all([name])
            lib = ctypes.CDLL(str(so))
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
