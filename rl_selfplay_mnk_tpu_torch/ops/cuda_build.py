"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source has a plain C interface and is compiled on first use by one
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``rl_selfplay_mnk_tpu_torch/_build/``, under a name keyed on a hash of the
source, the headers beside it (``csrc/*.cuh``) and the flags, then loaded
with ``ctypes``. Nothing is built at
import time. ``build_all`` starts one ``nvcc`` per source, all at once.

A failed build or launch raises ``KernelError``; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("env_step", "resblock", "attention", "attention_bwd", "attention_folded_bwd",
           "attention_board", "layer_norm", "short_conv", "moe")

_lock = threading.Lock()
_libs: dict = {}


class KernelError(RuntimeError):
    """A CUDA kernel failed to build, load or launch."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one source; returns (Popen, tmp, out) or None if built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed for {name}.cu:\n{log.decode(errors='replace')}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Compile every listed source that is not built yet, in parallel."""
    with _lock:
        jobs = {name: _start_build(name) for name in names}
        for name, job in jobs.items():
            if job is not None:
                _finish_build(name, job)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            try:
                _libs[name] = ctypes.CDLL(str(library_path(name)))
            except OSError as exc:
                raise KernelError(f"cannot load the built {name} kernel: {exc}") from exc
        return _libs[name]


def check_launch(name: str, code: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch entry."""
    if code != 0:
        raise KernelError(f"CUDA kernel {name} failed to launch: cudaError {code}")
