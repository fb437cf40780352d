"""A CPU rehearsal of ``chip_smoke.py``'s phases 14 (``phase_control``),
15 (``phase_adapters``, its rule files in the test's temporary directory)
and 16 (``phase_operator``, its snapshots and mode file there too), so that
a phase broken on the host shows here before a card run.

Each phase runs at a small size on the CPU (3,000 flows; a few hundred RLS
requests and a 20,000-event sketch stream, or 1,000 HTTP requests over
1,600 routes and half-second timed runs, or 40 pulls of 256 rows and
400 entries), with the kernels' wrappers
swapped for their plain versions plus the launch-count bump a CUDA launch
makes, and the impl resolvers forced to the kernel path, so that every
check of the phase (twin equality, launch counts, over-admission,
undercounts, bitwise states, the rule push) runs as on the card. Only what
needs the card is stubbed: ``torch.cuda.synchronize``,
``torch.cuda.set_sync_debug_mode`` and the card's name.
"""

import os
import shutil
import sys

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no C++ compiler for the native doors",
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counted(plain, launches, key):
    def wrapper(*args, **kwargs):
        launches[key] += 1
        return plain(*args, **kwargs)

    return wrapper


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as CS

    from sentinel_tpu_torch.engine import decide as ED
    from sentinel_tpu_torch.engine import param as EP
    from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda
    from sentinel_tpu_torch.ops import decide_cuda as K

    monkeypatch.setattr(ED, "resolve_decide_impl",
                        lambda impl, device: "xla" if impl == "xla"
                        else "pallas")
    monkeypatch.setattr(EP, "resolve_param_impl",
                        lambda impl, device: "jax" if impl == "jax"
                        else "pallas")
    monkeypatch.setattr(K, "decide_rows", _counted(
        K.decide_rows_plain, K.LAUNCHES, "decide_rows"))
    monkeypatch.setattr(cms_cuda, "cms_decide_update", _counted(
        cms_cuda.cms_decide_update_plain, cms_cuda.LAUNCHES,
        "cms_decide_update"))
    monkeypatch.setattr(salsa_cuda, "salsa_decide_update", _counted(
        salsa_cuda.salsa_decide_update_plain, salsa_cuda.LAUNCHES,
        "salsa_decide_update"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda *a, **k: None)
    for name, value in dict(
            F=3000, SIZES=(64, 256, 1024), RLS_DESCRIPTORS=600,
            RLS_DOMAINS=4, RLS_COUNT_BASE=2, RLS_REQUESTS=150,
            RLS_SHM_REQUESTS=30, ROUTE_ROUNDS=1, ROUTE_FLOWS=10,
            ROUTE_MOVED_FLOWS=6, ROUTE_PARAMS=4, ROUTE_LIVE_S=(0.3, 0.3),
            SKETCH_KEYS=2000, SKETCH_EVENTS=20_000, SKETCH_BATCH=2048,
            SKETCH_PREFIX=(4096, 512)).items():
        monkeypatch.setattr(CS, name, value)
    monkeypatch.setattr(sys, "path", [os.path.join(REPO, "tests")]
                        + sys.path)
    return CS


def test_phase_control_rehearses_on_the_cpu(smoke):
    out = smoke.phase_control(torch, "cpu")
    rls = out["rls"]
    assert rls["in_process"]["launches"] == 150
    assert rls["in_process"]["sync_free_dispatches"] == 150
    assert rls["in_process"]["fallbacks"] == {"rls_allow": 0, "rls_deny": 0}
    assert rls["shm"]["launches"] == 30
    lock = out["routing"]["lockstep"]
    assert lock["decide_launches"] == (lock["before"]["flow"]
                                       + lock["after"]["flow"])
    assert lock["param_launches"] == (lock["before"]["param"]
                                      + lock["after"]["param"])
    assert lock["answers_from_destination"] > 0
    live = out["routing"]["live"]
    assert live["over_admission"] == 0 and live["moved_answers"] > 0
    for sketch in ("cms", "salsa"):
        s = out["sketch"][sketch]
        assert s["launches"] == s["batches"] == 10
        assert s["report"]["undercounts"] == 0
        assert s["report"]["slim"]["undercounts"] == 0
        assert s["gate"]["width"] == 512  # the reference gate's own
    assert set(out["codec"]) == {64, 1024, 5040}


def test_phase_adapters_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
    for name, value in dict(
            ADAPTER_ROUTES=1600, ADAPTER_REQUESTS=1000, ADAPTER_SECONDS=0.5,
            ADAPTER_PLAN=200, ADAPTER_WRITES=2,
            ADAPTER_RULES=str(tmp_path)).items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "gpu_identity", lambda: "cpu")
    from sentinel_tpu_torch.datasource import base

    # the phase wants no failed refresh, and the counters are the
    # process's: other tests in this process count into them
    base.reset_refresh_failures_for_tests()
    out = smoke.phase_adapters(torch, "cpu")
    lock = out["lockstep"]
    assert lock["decide_launches"] == lock["flow_checks"] > 0
    assert lock["sync_free_dispatches"] == lock["flow_checks"]
    assert lock["cms_launches"] == lock["param_checks"] > 0
    assert lock["rule_epoch_step"] == 1
    assert (lock["pushed_after"].get("429", 0)
            > lock["pushed_before"].get("429", 0))
    for mode in ("cluster", "local"):
        t = out["timed"][mode]
        assert t["requests"] > 0 and set(t["statuses"]) <= {200, 429, 500}
    assert out["timed"]["local"]["service_calls"]["request_token"] == 0
    assert out["timed"]["push"]["write_to_answer_ms"]["n"] == 2


def test_phase_operator_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
    for name, value in dict(
            OPERATOR_PULLS=40, OPERATOR_ROWS=256, OPERATOR_ENTRIES=400,
            OPERATOR_HEIR_PULLS=4, OPERATOR_FLIP_PULLS=2, OPERATOR_SCRAPES=3,
            OPERATOR_LOOP_S=0.3, OPERATOR_PUSHES=1, OPERATOR_REPS=2,
            OPERATOR_ROOT=str(tmp_path)).items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "gpu_identity", lambda: "cpu")
    out = smoke.phase_operator(torch, "cpu")
    lock = out["lockstep"]
    assert lock["decide_launches"] == lock["device_steps"] > 40
    assert lock["sync_free_dispatches"] == lock["device_steps"]
    assert lock["cms_launches"] == lock["param_checks"] >= 40
    assert len(lock["probes"]) == 4 and lock["heartbeats"] >= 1
    assert lock["metric_log_bytes"] > 0 and lock["scrapes"] == 4
    timed = out["timed"]
    assert timed["loop"]["scraped"]["scrapes"] >= 1
    assert timed["loop"]["quiet"]["pulls"] > 0
    assert timed["modify_flow_rules_first_verdict_ms"]["n"] == 1
    assert timed["snapshot_fetch_bytes"] > 0


def test_phase_mesh_rehearses_on_the_cpu(smoke, monkeypatch):
    """Phase 17 with the mesh's four shards on the CPU."""
    for name, value in dict(
            PULLS=(64, 256, 1024, 4096), MESH_ROUNDS=2,
            MESH_PARAM_REQUESTS=40, MESH_STANDBY_PULLS=1, MESH_DOOR_PULLS=2,
            MESH_TIMED=2).items():
        monkeypatch.setattr(smoke, name, value)
    monkeypatch.setattr(smoke, "gpu_identity", lambda: "cpu")
    monkeypatch.setattr(smoke, "cuda_ms", lambda fn, reps, torch: 0.0)
    out, _profiled = smoke.phase_mesh(torch, "cpu")
    lock = out["lockstep"]
    # one launch a shard a frame, on the rows the shard owns; the last
    # frame (SIZES[1] rows) leaves one shard without a row
    assert lock["frames"] == 2 * (3 + 4) + 1
    assert lock["decide_launches"] == lock["shard_frames"] == 4 * lock[
        "frames"]
    assert lock["empty_shard_frames"] >= 1
    assert lock["empty_shard_launch"]["rows"] == 0
    assert lock["rows_covered"]["mesh"] == 2 * (64 + 256 + 1024 + 4096) + (
        smoke.SIZES[1])
    assert lock["twin_launches"] == lock["frames"]
    assert lock["reported"] > 0 and lock["breakers_not_closed"] > 0
    assert out["door"]["verdicts"] == 2 * (64 + 256 + 1024)
    assert out["pull_ms"]["mesh"]["n"] == 2
    launches = out["launch_of_pull"]
    assert launches["no_mesh"]["rows"] == 1024
    assert sum(v["rows"] for k, v in launches.items()
               if k != "no_mesh") == 1024


def test_phase_dashboard_rehearses_on_the_cpu(smoke, monkeypatch, tmp_path):
    """Phase 18 at 3,000 flows, its files in the test's directory."""
    monkeypatch.setattr(smoke, "DASH_ROOT", str(tmp_path))
    monkeypatch.setattr(smoke, "gpu_identity", lambda: "cpu")
    out = smoke.phase_dashboard(torch, "cpu")
    assert out["decide_launches"] == out["device_steps"] > 0
    assert out["entry_blocks"] > 0 and out["pulls"] == 9
    assert out["monitor_bytes"] > 0
