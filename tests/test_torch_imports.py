"""The port imports neither JAX nor the JAX package: a fresh interpreter
imports every ``sentinel_tpu_torch`` module, then ``jax`` and
``sentinel_tpu`` must be absent from ``sys.modules``."""

import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    import sentinel_tpu_torch

    names = ["sentinel_tpu_torch"]
    for info in pkgutil.walk_packages(sentinel_tpu_torch.__path__,
                                      "sentinel_tpu_torch."):
        names.append(info.name)
    return names


def test_port_modules_import_without_jax():
    names = _modules()
    assert "sentinel_tpu_torch.ops.decide_cuda" in names
    assert "sentinel_tpu_torch.cluster.token_service" in names
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'sentinel_tpu' or "
        "m.startswith('sentinel_tpu.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n"
    )
    # -I: no user site or PYTHON* variables, so nothing preloads JAX
    out = subprocess.run(
        [sys.executable, "-I", "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-2000:]


def _port_sources():
    """The port's Python sources (its build outputs aside), the smoke
    script and the workloads the smoke imports."""
    root = os.path.join(REPO, "sentinel_tpu_torch")
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "build"]
        yield from (os.path.join(dirpath, f) for f in files
                    if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tests", "torch_kernel_check.py")


def test_port_sources_never_name_jax():
    for f in _port_sources():
        with open(f) as fh:
            for line in fh:
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert not mod.startswith(("jax", "sentinel_tpu.")), (
                        f, s)
                    assert mod != "sentinel_tpu", (f, s)
