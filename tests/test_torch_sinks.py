"""The host sinks of the port's token service against the JAX package's.

One seeded stream (``torch_ha_check``: Zipf pulls, reports drawn from what
each pull admitted, param requests, every flow behind a breaker) runs on a
JAX and a port service on both packages' ``ManualClock``, with a move begun
and aborted midway. Breaker scans run only where the test forces them
(``breaker_stats`` after each round), so their edges are the same in both
packages. Then, between the packages:

- the breaker-transition counters (``ServerMetrics.breaker_transition_
  totals``) and the blackbox dump reasons (``breaker_open:<flow ids>``,
  ``move_abort:<namespace>``);
- the cluster stat log's lines (verdict classes and ``outcome_reported``),
  written into a temporary directory;
- the timeline's per-namespace rows (pass, block, completions, exceptions,
  RT sums, summed over the seconds the run spanned) and the SLO plane's
  completion side (counts, RT quantiles, RT burn windows);
- the provider-fed blocks of ``ServerMetrics.snapshot()`` (sketch, lease,
  outcome, breaker).

And ``sketch_stats()`` for both sketches with the slim twin on and off.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu.metrics import stat_logger as j_stat_logger  # noqa: E402
from sentinel_tpu.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as j_reset_metrics,
    server_metrics as j_server_metrics,
)
from sentinel_tpu.metrics.timeline import timeline as j_timeline  # noqa: E402
from sentinel_tpu.trace import blackbox as j_blackbox  # noqa: E402
from sentinel_tpu.trace.slo import slo_plane as j_slo_plane  # noqa: E402

from sentinel_tpu_torch.core.config import SentinelConfig  # noqa: E402
from sentinel_tpu_torch.metrics import stat_logger as t_stat_logger  # noqa: E402
from sentinel_tpu_torch.metrics.server import (  # noqa: E402
    reset_server_metrics_for_tests as t_reset_metrics,
    server_metrics as t_server_metrics,
)
from sentinel_tpu_torch.metrics.timeline import (  # noqa: E402
    timeline as t_timeline,
)
from sentinel_tpu_torch.trace import blackbox as t_blackbox  # noqa: E402
from sentinel_tpu_torch.trace.slo import slo_plane as t_slo_plane  # noqa: E402
from torch_ha_check import (  # noqa: E402
    JAX,
    PARAM_FLOWS,
    PORT,
    manual_clocks,
    same,
    traffic,
)

SEED = 0x51C
PROVIDER_BLOCKS = ("sketch", "lease", "outcome", "breaker")
SLO_COMPLETION_KEYS = ("completed", "exceptions", "rtP50Ms", "rtP99Ms",
                       "rtMaxMs", "rtBurnRate", "rtWindows")


@pytest.fixture
def planes(tmp_path, monkeypatch):
    """Both packages' metric singletons reset, their stat logs in
    ``tmp_path`` (``jax/``, ``port/``), their blackbox dumps captured by
    reason. Yields ``{"jax": [reasons], "port": [reasons]}``."""
    j_reset_metrics()
    t_reset_metrics()
    j_stat_logger.reset_registry_for_tests()
    t_stat_logger.reset_registry_for_tests()
    monkeypatch.setenv("SENTINEL_LOG_DIR", str(tmp_path / "jax"))
    prev_dir = SentinelConfig.get(t_stat_logger.LOG_DIR_KEY)
    SentinelConfig.set(t_stat_logger.LOG_DIR_KEY, str(tmp_path / "port"))
    dumps = {"jax": [], "port": []}
    monkeypatch.setattr(j_blackbox, "maybe_dump", dumps["jax"].append)
    monkeypatch.setattr(t_blackbox, "maybe_dump", dumps["port"].append)
    try:
        yield dumps
    finally:
        j_stat_logger.reset_registry_for_tests()
        t_stat_logger.reset_registry_for_tests()
        SentinelConfig.set(t_stat_logger.LOG_DIR_KEY, prev_dir or "")
        j_reset_metrics()
        t_reset_metrics()


def _stat_lines(module, directory) -> list:
    module.stat_logger(module.CLUSTER_LOG).flush()
    path = os.path.join(directory, module.CLUSTER_LOG + ".log")
    with open(path, encoding="utf-8") as f:
        return f.read().splitlines()


def _timeline_rows(tl) -> dict:
    """``{namespace: (pass, block, completed, exceptions, rtSumMs)}`` over
    every sample in the timeline's window."""
    out = {}
    for s in tl.query(0, None):
        d = s.as_dict()
        row = out.setdefault(d["namespace"], [0, 0, 0, 0, 0])
        for i, key in enumerate(("pass", "block", "completed", "exceptions",
                                 "rtSumMs")):
            row[i] += d[key]
    return out


def _slo_completions(plane) -> dict:
    return {ns: {k: t[k] for k in SLO_COMPLETION_KEYS}
            for ns, t in plane.snapshot()["tenants"].items()}


def test_sinks_are_equal_between_packages(planes, tmp_path):
    with manual_clocks() as clocks:
        services = [JAX.make(), PORT.make()]
        for s in services:
            # scans only where the test forces them (see the docstring)
            s._breaker_scan_ts = float("inf")
        rng = np.random.default_rng(SEED)
        for rnd in range(8):
            traffic(services, clocks, rng, rounds=1,
                    check=lambda kind, outs: same(outs))
            same([s.breaker_stats() for s in services])
            if rnd == 3:
                for s in services:
                    s.begin_move("ns1", "10.0.0.5:5", 2)
                traffic(services, clocks, rng, rounds=1,
                        check=lambda kind, outs: same(outs))
                for s in services:
                    s.abort_move("ns1")
        jm, tm = j_server_metrics(), t_server_metrics()
        edges = tm.breaker_transition_totals()
        assert edges == jm.breaker_transition_totals()
        assert edges.get(("closed", "open")), edges
        assert planes["jax"] == planes["port"]
        assert "move_abort:ns1" in planes["port"]
        assert any(r.startswith("breaker_open:") for r in planes["port"])
        lines = _stat_lines(t_stat_logger, tmp_path / "port")
        assert lines == _stat_lines(j_stat_logger, tmp_path / "jax")
        events = {line.split("|")[1] for line in lines}
        assert {"pass", "block", "degraded", "outcome_reported"} <= events
        rows = _timeline_rows(t_timeline())
        assert rows == _timeline_rows(j_timeline())
        assert rows["default"][2] and rows["ns1"][3], rows
        assert _slo_completions(t_slo_plane()) == _slo_completions(
            j_slo_plane())
        js, ts = jm.snapshot(), tm.snapshot()
        for block in PROVIDER_BLOCKS:
            assert ts[block] == js[block], block
        assert ts["outcome"]["reported"] and ts["breaker"]["flows"]
        assert ts["sketch"]["impl"] == "jax"


@pytest.mark.parametrize("sketch", ["cms", "salsa"])
@pytest.mark.parametrize("slim_width", [256, 0])
def test_sketch_stats_are_equal(sketch, slim_width):
    with manual_clocks() as clocks:
        services = [JAX.make(sketch=sketch, slim_width=slim_width),
                    PORT.make(sketch=sketch, slim_width=slim_width)]
        for s, kind in zip(services, (JAX, PORT)):
            s.load_param_rules([kind.param_rule(flow_id=f, count=1e9)
                                for f in PARAM_FLOWS])
        rng = np.random.default_rng(SEED + 1)
        # few hot values and large acquires: SALSA pairs saturate and merge
        vals = rng.integers(-2 ** 63, 2 ** 63 - 1, size=8, dtype=np.int64)
        for k in range(12):
            hashes = [int(h) for h in vals[rng.integers(0, 8, 8)]]
            fid = PARAM_FLOWS[k % len(PARAM_FLOWS)]
            same([int(s.request_params_token(fid, 9000, hashes).status)
                  for s in services])
            for c in clocks:
                c.advance(90)
        stats = [s.sketch_stats() for s in services]
        assert stats[0] == stats[1]
        assert stats[1]["slimBytes"] == (0 if slim_width == 0 else
                                         8 * 2 * 2 * slim_width * 4)
        if sketch == "salsa":
            assert stats[1]["mergesTotal"] > 0
