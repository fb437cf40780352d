"""The port's command center against the JAX package's, on the CPU.

One seeded command sequence (``torch_operator_check.command_plan``: rule
CRUD on every rule type, gateway API definitions, ``setClusterMode``
promoting a CPU token service, the ``cluster/server/*`` commands, pulls
from the embedded service and local entries in between) goes to each
package's ``CommandCenter`` over HTTP, each package on its own
``ManualClock`` at the same readings. Then:

- every response is equal as JSON, less the fields that carry a time, a
  pid, a host name or a port (``torch_operator_check.VOLATILE_KEYS``);
- every pull's verdicts are equal;
- the two exporters' renders are equal line for line, less the build's
  identity, the uptime and the families that measure host durations
  (``torch_operator_check.EXCLUDED_FAMILIES``);
- the two metric logs, written each second by each package's
  ``MetricTimer``, are equal byte for byte, and so are the ``metric``
  command's answers.

Each package's ``setClusterMode`` builds the same small service: the JAX
package's ``DefaultTokenService`` name is bound to a subclass with the
small configuration (its handlers build ``DefaultTokenService()``), the
port's command center gets a ``server_factory``.
"""

import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler for the native library (local windows)",
)

import sentinel_tpu.cluster.token_service as jts  # noqa: E402
from sentinel_tpu.core.config import SentinelConfig as JSentinelConfig  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402

import torch_operator_check as OC  # noqa: E402
import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from torch_ha_check import manual_clocks  # noqa: E402
from sentinel_tpu_torch.cluster import token_service as tts  # noqa: E402
from sentinel_tpu_torch.core.config import SentinelConfig  # noqa: E402
from sentinel_tpu_torch.engine import EngineConfig  # noqa: E402
from sentinel_tpu_torch.metrics.stat_logger import LOG_DIR_KEY  # noqa: E402

SEED = 1301
SMALL = dict(max_flows=256, max_namespaces=8, batch_size=64)
ENTRIES = 12  # local entries a pull step, over the flow rules' resources


class SmallJaxService(jts.DefaultTokenService):
    """What the JAX handlers' ``DefaultTokenService()`` builds here."""

    def __init__(self, config=None, **kw):
        kw.setdefault("serve_buckets", (64,))
        kw.setdefault("fuse_depths", ())
        super().__init__(config or JConfig(**SMALL), **kw)


def port_server(server_cls, host, port):
    return server_cls(
        tts.DefaultTokenService(EngineConfig(**SMALL), device="cpu",
                                serve_buckets=(64,), fuse_depths=()),
        host=host, port=port)


def _run(P, clock, steps, server_factory=None):
    """The plan through the package ``P``'s command center."""
    OC.reset(P)
    kwargs = {} if server_factory is None else dict(
        server_factory=server_factory)
    cc = P.command.CommandCenter(host="127.0.0.1", port=0, **kwargs).start()
    timer = P.log.MetricTimer(P.log.MetricWriter())
    rng = np.random.default_rng(SEED + 1)
    responses, pulls, entries = [], [], []
    second = clock.now_ms() // 1000
    try:
        for kind, a, body in steps:
            if kind == "cmd":
                status, text = OC.http(cc.port, a, body)
                responses.append((a, status, OC.normalize(text)))
            elif kind == "advance":
                clock.advance(a)
            else:
                ids = rng.integers(95, 100 + OC.PARITY_FLOWS + 5, a)
                svc = P.api.get_embedded_server()
                st, rem, wait = svc.request_batch_arrays(ids)
                pulls.append((st.tolist(), rem.tolist(), wait.tolist()))
                for k in range(ENTRIES):
                    try:
                        with P.L.entry(f"res{int(rng.integers(0, 6))}"):
                            entries.append("pass")
                            clock.advance(int(rng.integers(0, 3)))
                    except P.L.BlockException as exc:
                        entries.append(type(exc).__name__)
            if clock.now_ms() // 1000 != second:
                second = clock.now_ms() // 1000
                timer.writer.write(timer.collect_once())
        end = clock.now_ms()
        status, text = OC.http(cc.port,
                               f"metric?startTime=0&endTime={end}")
        responses.append(("metric", status, text))
        render = OC.series(P.exporter.render())
        timer.writer.close()
        logs = []
        metric_dir = P.log.default_metric_dir()
        for name in sorted(os.listdir(metric_dir)):
            with open(os.path.join(metric_dir, name), "rb") as f:
                logs.append((name, f.read()))
    finally:
        cc.stop()
        OC.reset(P)
    return dict(responses=responses, pulls=pulls, entries=entries,
                render=render, logs=logs)


@pytest.fixture
def log_dirs(tmp_path, monkeypatch):
    """Each package's metric log in a directory of its own, and both
    packages' properties as a fresh process has them: a test earlier in
    the process may have left one set (``benchmarks/scenario_bench.py``
    leaves the JAX package's SLO objective at its scenario's value)."""
    saved = [(c, dict(c._props)) for c in (JSentinelConfig, SentinelConfig)]
    for config, _ in saved:
        config._props.clear()
    monkeypatch.setenv("SENTINEL_LOG_DIR", str(tmp_path / "jax"))
    SentinelConfig.set(LOG_DIR_KEY, str(tmp_path / "port"))
    yield
    for config, props in saved:
        config._props.clear()
        config._props.update(props)


def test_commands_exposition_and_metric_log_equal_the_reference(
        log_dirs, monkeypatch):
    monkeypatch.setattr(jts, "DefaultTokenService", SmallJaxService)
    steps = OC.command_plan(np.random.default_rng(SEED))
    J = OC.package("sentinel_tpu")
    T = OC.package("sentinel_tpu_torch")
    with manual_clocks() as (jc, tc):
        ref = _run(J, jc, steps)
    with manual_clocks() as (jc, tc):
        got = _run(T, tc, steps, port_server)
    assert len(ref["responses"]) == len(got["responses"]) > 50
    for (path, s_ref, r_ref), (_, s_got, r_got) in zip(ref["responses"],
                                                      got["responses"]):
        assert (s_got, r_got) == (s_ref, r_ref), path
    assert got["pulls"] == ref["pulls"]
    assert got["entries"] == ref["entries"]
    assert {"pass", "FlowException"} <= set(ref["entries"])
    assert OC.first_difference(ref["render"], got["render"]) is None
    assert len(ref["render"]) > 100
    assert got["logs"] == ref["logs"] and ref["logs"]
    # the sequence reached what it is for
    answers = dict((p, r) for p, _, r in ref["responses"])
    assert "success" in answers["setClusterMode?mode=1&tokenPort=0"]
    assert "error" in answers["cluster/server/info"]  # after the demotion
    assert "static engine config" in answers[
        "cluster/server/modifyFlowConfig"]
