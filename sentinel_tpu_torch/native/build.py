"""Build the native front doors from the checkout's sources.

Compiles the repo's ``native/src/{sentinel_native,sentinel_frontdoor,
sentinel_shm}.cpp`` with ``g++ -O3 -std=c++17 -fPIC -shared -pthread`` (the
flags of ``native/Makefile``) into ``sentinel_tpu_torch/build/`` (git-ignored),
under a name that carries a hash of the sources, the compiler and the flags,
so an edited source is rebuilt rather than a stale library loaded. The
compile writes a temporary name and renames it into place under a file
lock, so processes that build at once (test workers) never load a partial
library. A failed compile raises with the compiler's output.

Run ``python -m sentinel_tpu_torch.native.build`` to build ahead of use.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG_DIR / "build"
SRC_DIR = PKG_DIR.parent / "native" / "src"
SOURCES = [
    SRC_DIR / "sentinel_native.cpp",
    SRC_DIR / "sentinel_frontdoor.cpp",
    SRC_DIR / "sentinel_shm.cpp",
]
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++`` or ``c++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (need g++ or c++ on PATH)")
    return cxx


def target() -> Path:
    """The library path for the current sources, compiler and flags."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join((compiler(),) + CXX_FLAGS).encode())
    return BUILD_DIR / f"libsentinel_native-{h.hexdigest()[:16]}.so"


def build() -> str:
    """Build the library unless it exists; returns its path."""
    out = target()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return str(out)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"native build failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
    return str(out)


if __name__ == "__main__":
    print(build())
