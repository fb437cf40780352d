"""A CPU rehearsal of ``chip_smoke.py``'s phase 14 (``phase_control``), so
that a phase broken on the host shows here before a card run.

The phase runs at a small size (3,000 flows, a few hundred RLS requests, a
20,000-event sketch stream) on the CPU, with the kernels' wrappers swapped
for their plain versions plus the launch-count bump a CUDA launch makes,
and the impl resolvers forced to the kernel path, so that every check of
the phase (twin equality, launch counts, over-admission, undercounts,
bitwise states) runs as on the card. Only what needs the card is stubbed:
``torch.cuda.synchronize`` and ``torch.cuda.set_sync_debug_mode``.
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
