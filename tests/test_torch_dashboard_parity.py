"""The port's dashboard and app stack against the JAX package's, on the
CPU.

One seeded session (``torch_dashboard_check.run``: heartbeat registration,
rule CRUD on every rule type through ``v1/rule``, gateway API definitions,
``v2/rules`` through a ``FileRuleStore`` the app watches, ``cluster/assign``
promoting a CPU token service and ``cluster/assign/manage`` unassigning it,
SDK entries and embedded-service pulls, the fetcher's pull and the metric
queries, ``cluster/monitor``) goes through each package in turn, each on
its own ``ManualClock`` at the same readings. Every answer must be equal
once normalized (``torch_dashboard_check.normalize``): the fields
``torch_dashboard_check.VOLATILE_KEYS`` names are dropped (``currentTime``,
``pid``, ``hostname``, ``port``, ``wall_ms``, ``clients``, ``version``,
``buildInfo``, ``stats``), and the command center's, the dashboard's and
the token server's port numbers are written as names wherever an address
or a ``tokenPort`` / ``serverPort`` field carries them. Every entry's
verdict and every pull's verdicts must be equal too, and in each package
the dashboard's metric totals must equal the app's metric-log totals.
"""

import shutil

import pytest

pytest.importorskip("torch")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler for the native library (local windows)",
)

import sentinel_tpu.cluster.token_service as jts  # noqa: E402
from sentinel_tpu.core.config import SentinelConfig as JSentinelConfig  # noqa: E402
from sentinel_tpu.engine import ClusterFlowRule as JRule  # noqa: E402
from sentinel_tpu.engine import EngineConfig as JConfig  # noqa: E402

import torch_dashboard_check as DC  # noqa: E402
import torch_parity  # noqa: E402,F401  (stat logs to a temp dir)
from torch_ha_check import manual_clocks  # noqa: E402
from torch_operator_check import first_difference  # noqa: E402
from sentinel_tpu_torch.cluster import token_service as tts  # noqa: E402
from sentinel_tpu_torch.core.config import SentinelConfig  # noqa: E402
from sentinel_tpu_torch.engine import ClusterFlowRule, EngineConfig  # noqa: E402
from sentinel_tpu_torch.metrics.stat_logger import LOG_DIR_KEY  # noqa: E402

SEED = 1401
SMALL = dict(max_flows=64, max_namespaces=4, batch_size=256)
FLOWS = list(range(500, 504))  # the token server's flows


def _rules(rule_cls):
    return [rule_cls(flow_id=f, count=3.0 + f % 3) for f in FLOWS]


class SmallJaxService(jts.DefaultTokenService):
    """What the JAX handlers' ``DefaultTokenService()`` builds here: the
    small configuration, with the session's cluster rules."""

    def __init__(self, config=None, **kw):
        kw.setdefault("serve_buckets", (256,))
        kw.setdefault("fuse_depths", ())
        super().__init__(config or JConfig(**SMALL), **kw)
        self.load_rules(_rules(JRule))


def port_server(server_cls, host, port):
    svc = tts.DefaultTokenService(EngineConfig(**SMALL), device="cpu",
                                  serve_buckets=(256,), fuse_depths=())
    svc.load_rules(_rules(ClusterFlowRule))
    return server_cls(svc, host=host, port=port)


@pytest.fixture
def log_dirs(tmp_path, monkeypatch):
    """Each package's logs in a directory of its own, and both packages'
    properties as a fresh process has them, restored after."""
    saved = [(c, dict(c._props)) for c in (JSentinelConfig, SentinelConfig)]
    for config, _ in saved:
        config._props.clear()
    monkeypatch.setenv("SENTINEL_LOG_DIR", str(tmp_path / "jax"))
    SentinelConfig.set(LOG_DIR_KEY, str(tmp_path / "port"))
    yield tmp_path
    for config, props in saved:
        config._props.clear()
        config._props.update(props)


def _free_port():
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def test_dashboard_session_equals_the_reference(log_dirs, monkeypatch):
    monkeypatch.setattr(jts, "DefaultTokenService", SmallJaxService)
    out = {}
    for name, factory in (("sentinel_tpu", None),
                          ("sentinel_tpu_torch", port_server)):
        P = DC.package(name)
        with manual_clocks() as (jc, tc):
            clock = jc if name == "sentinel_tpu" else tc
            out[name] = DC.run(P, clock, factory, str(log_dirs / name),
                               _free_port(), FLOWS, SEED)
    ref, got = out["sentinel_tpu"], out["sentinel_tpu_torch"]
    assert len(ref["responses"]) == len(got["responses"]) > 60
    assert first_difference(ref["responses"], got["responses"]) is None
    assert got["entries"] == ref["entries"]
    assert got["pulls"] == ref["pulls"]
    for run in (ref, got):
        assert run["dashboard_totals"] == run["log_totals"]
        assert run["dashboard_totals"]["pass"] > 0
        assert run["dashboard_totals"]["block"] > 0
    # the session reached what it is for
    answers = {label: text for label, _, text in ref["responses"]}
    assert '"server": true' in answers["assign"]
    assert '"unassigned": 1' in answers["unassign"]
    entries = [v for rnd in ref["entries"] for v in rnd]
    assert {"pass", "FlowException"} <= set(entries)

