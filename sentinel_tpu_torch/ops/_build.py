"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), placed in
``sentinel_tpu_torch/build/`` (git-ignored) under a name that carries a hash
of the source and the flags, so an edited source is rebuilt rather than a
stale library loaded. Nothing here runs at import time: the CPU hosts that
run the tests have no ``nvcc``.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3`` and
``--fmad=false``: the kernels are held bitwise against the reference, whose
float expressions are never contracted into fused multiply-adds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME); the CUDA kernels are built at "
        "first use on a host with the CUDA toolkit"
    )


def _target(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start one nvcc for ``csrc/<name>.cu`` unless its library exists."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    proc.sentinel_args = (name, tmp, out)  # type: ignore[attr-defined]
    return proc


def _finish(proc: subprocess.Popen) -> None:
    name, tmp, out = proc.sentinel_args  # type: ignore[attr-defined]
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile every source not yet built, one ``nvcc`` per source, all
    started together. Returns ``{name: ptxas/nvcc log}``."""
    names = list(names or sources())
    procs = [p for p in (_start(n) for n in names) if p is not None]
    for proc in procs:
        _finish(proc)
    logs = {}
    for n in names:
        log = BUILD_DIR / f"{n}.log"
        logs[n] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
