"""Build the hand-written CUDA kernels with plain nvcc, and the host
libraries (imaging, the native pipeline) with g++, and load them with
ctypes.

Each source in ``s2r_tpu_torch/csrc/<name>.cu`` exposes a C interface (raw
pointers, int64 sizes, a ``cudaStream_t``) and compiles on its own into
``s2r_tpu_torch/_build/<name>-<hash>.so``, where the hash covers the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header builds anew and an unchanged one is reused.  The host sources
(``csrc/host/<name>.cpp``, C++ for the data pipeline's threads, sharing the
PNG reader ``csrc/host/png.h``) build the same way with g++ (``GXX_FLAGS``:
no ``-march``, and no contraction into fused multiply-adds, which would
move Pillow's double coefficients by an ulp) and link zlib
(``GXX_LIBS``); their hash covers ``csrc/host/*.h``.  The build directory
is the only place the package writes, and git ignores it.  Nothing here runs at import time: a library is built at its
first use, or ahead of time by ``build_all``, which starts one compiler per
source at once.  A failed build raises.  ``batch_chunks`` cuts a batch into
runs of whole items that a kernel indexing in 32 bits can take in one
launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("depthwise", "requant", "batchnorm", "disc_conv")
HOST_DIR = SRC_DIR / "host"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-ffp-contract=off")
GXX_LIBS = ("-lz",)
HOST_SOURCES = ("imaging", "pipeline")

# Kernels that index in 32 bits take fewer elements than this per launch.
INDEX_LIMIT = 2 ** 31

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


def gxx_path() -> str:
    """g++ from $PATH; raises if absent."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host libraries need it")
    return found


def _source(name: str) -> Path:
    return HOST_DIR / f"{name}.cpp" if name in HOST_SOURCES \
        else SRC_DIR / f"{name}.cu"


def _target(name: str) -> Path:
    src = _source(name).read_bytes()
    if name in HOST_SOURCES:
        extra = b"".join(h.read_bytes() for h in sorted(HOST_DIR.glob("*.h")))
        flags = GXX_FLAGS + GXX_LIBS
    else:
        extra = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
        flags = NVCC_FLAGS
    digest = hashlib.sha256(src + extra + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


class _Build:
    """One compiler process (nvcc, or g++ for a host source) writing `so`
    through a temporary file."""

    def __init__(self, name: str, so: Path):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.so = so
        self.tmp = so.with_suffix(f".{os.getpid()}.tmp")
        host = name in HOST_SOURCES
        compiler = [gxx_path(), *GXX_FLAGS] if host \
            else [nvcc_path(), *NVCC_FLAGS]
        self.cmd = [*compiler, "-o", str(self.tmp), str(_source(name)),
                    *(GXX_LIBS if host else ())]
        self.proc = subprocess.Popen(self.cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def finish(self) -> None:
        out, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            self.tmp.unlink(missing_ok=True)
            raise RuntimeError(f"build failed ({self.proc.returncode}): "
                               f"{' '.join(self.cmd)}\n{out}")
        os.replace(self.tmp, self.so)  # atomic: no reader sees half a file

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.tmp.unlink(missing_ok=True)


def build_all(names: Iterable[str] = SOURCES + HOST_SOURCES) -> List[Path]:
    """Build every named library not yet built, one compiler each, all at
    once."""
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
    """The loaded library `name` (a kernel, or a host source), built first
    if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = _target(name)
            if not so.exists():
                build_all([name])
            lib = ctypes.CDLL(str(so))
            _LIBS[name] = lib
        return lib


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on t's device (what
    torch.cuda.current_stream().cuda_stream gives, without building a
    Stream object: a few microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def batch_chunks(n: int, per_item: int, limit: int = INDEX_LIMIT
                 ) -> List[Tuple[int, int]]:
    """[(start, stop), ...] cutting n items of per_item elements each into
    the fewest runs of whole items that each hold fewer than `limit`
    elements, in order.  Raises if one item alone reaches `limit`."""
    if per_item >= limit:
        raise ValueError(f"one batch item holds {per_item} elements, at or "
                         f"over the kernels' per-launch limit of {limit}")
    step = (limit - 1) // per_item if per_item else max(n, 1)
    return [(a, min(a + step, n)) for a in range(0, n, step)]
