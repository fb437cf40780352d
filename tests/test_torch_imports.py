"""The port imports neither JAX nor the JAX package: a fresh interpreter
imports every ``sentinel_tpu_torch`` module, then ``jax`` and
``sentinel_tpu`` must be absent from ``sys.modules``; also after the native
door's library is built and loaded, and a door has served a frame."""

import os
import pkgutil
import shutil
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
    for mod in ("ops.decide_cuda", "ops.cms_cuda", "ops.salsa_cuda",
                "ops.prefix_cuda", "engine.param", "engine.outcome",
                "sketch", "sketch.salsa", "sketch.slim", "cluster.concurrent",
                "cluster.token_service", "chaos", "core.config", "core.log",
                "cluster.protocol", "cluster.connection", "cluster.push",
                "cluster.server_native", "metrics.histogram", "metrics.ha",
                "metrics.timeline", "metrics.server", "metrics.profiler",
                "trace.ring", "trace.spans", "trace.slo", "trace.blackbox",
                "overload", "overload.admission", "native.build",
                "native.lib"):
        assert f"sentinel_tpu_torch.{mod}" in names, mod
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


_SERVE_ONE_FRAME = """
import sys
sys.path.insert(0, {repo!r})
import numpy as np
from sentinel_tpu_torch.cluster import protocol as P
from sentinel_tpu_torch.cluster.server_native import NativeTokenServer
from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig
from sentinel_tpu_torch.native import lib
lib.load()
svc = DefaultTokenService(EngineConfig(max_flows=8, max_namespaces=2,
                                       batch_size=64), device="cpu")
svc.load_rules([ClusterFlowRule(1, 3.0)])
server = NativeTokenServer(svc, port=0, idle_ttl_s=None)
server.start()
try:
    import socket
    s = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    s.sendall(P.encode_batch_request(7, np.full(5, 1, np.int64)))
    frames, reader = [], P.FrameReader()
    while not frames:
        frames = reader.feed(s.recv(4096))
    xid, st, _r, _w = P.decode_batch_response(frames[0])
    assert xid == 7 and st.tolist() == [0, 0, 0, 1, 1], st
    s.close()
finally:
    server.stop()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sentinel_tpu" or m.startswith("sentinel_tpu."))
assert not bad, bad
"""


def test_native_door_serves_without_jax():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler on PATH to build the native door")
    out = subprocess.run(
        [sys.executable, "-I", "-c", _SERVE_ONE_FRAME.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
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
    yield os.path.join(REPO, "tests", "torch_param_check.py")
    yield os.path.join(REPO, "tests", "torch_outcome_check.py")
    yield os.path.join(REPO, "tests", "torch_door_check.py")


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
