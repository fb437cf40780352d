"""The CUDA decide kernel against its plain PyTorch version.

Tests marked ``gpu`` need an NVIDIA card and ``nvcc``; they skip on hosts
without one (the check runs inside a fixture, never at import). On the card,
run them with ``python -m pytest --noconftest tests/test_torch_kernels.py``
(the suite's conftest imports jax, which the card's host need not have). The
unmarked tests cover the wrapper's CPU dispatch and the seeded workloads.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sentinel_tpu_torch.engine import EngineConfig, build_rule_table  # noqa: E402
from sentinel_tpu_torch.engine.state import make_state  # noqa: E402
from sentinel_tpu_torch.ops import decide_cuda  # noqa: E402
import torch_kernel_check as DC  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(device, F=4096, NS=8, N=1024, seed=0):
    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=N)
    rng = np.random.default_rng(seed)
    rules = DC.mixed_rules(F, NS, rng)
    table, index = build_rule_table(cfg, rules, ns_max_qps=1e9,
                                    connected={"ns1": 3}, device=device)
    tight = index.namespace_slot(DC.TIGHT_NS)
    table.ns_max_qps[tight] = 40.0
    return cfg, rng, table, make_state(cfg, device=device)


STEPS = len(DC.STEP_OFFSETS_MS)


def _run(device, N, uniform, seed):
    cfg, rng, table, state = _setup(device, N=max(N, 64), seed=seed)
    zipf = DC.ZipfIds(cfg.max_flows)
    nows = [10_040 + dt for dt in DC.STEP_OFFSETS_MS]
    batches = [DC.grouped_batch(cfg, rng, zipf, N, uniform, unknown=N // 50)
               for _ in nows]
    return DC.check_steps(cfg, table, state, batches, nows, uniform)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [64, 1024, 3000])
@pytest.mark.parametrize("uniform", [True, False])
def test_kernel_matches_plain(cuda, N, uniform):
    before = decide_cuda.LAUNCHES["decide_rows"]
    max_err, mismatches, _, _, reached = _run(cuda, N, uniform, seed=N)
    torch.cuda.synchronize()
    assert not mismatches, mismatches[:10]
    assert max_err == 0.0
    assert decide_cuda.LAUNCHES["decide_rows"] - before == STEPS
    # the ring wrapped onto written columns and expiring counts were read
    assert reached == set(DC.COVERAGE), reached


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs(cuda):
    cfg, rng, table, state = _setup(cuda, F=256, N=64)
    zipf = DC.ZipfIds(cfg.max_flows)
    batch = DC.grouped_batch(cfg, rng, zipf, 40, True)
    config, flow, occ, fst, ost, now, good, _ = DC.kernel_args(
        cfg, table, state, batch, 1000, uniform=True)
    cols = dict(good)
    cols["acquire"] = cols["acquire"].to(torch.int64)
    with pytest.raises(TypeError):
        decide_cuda.decide_rows(config, flow, occ, fst, ost, now, cols, True)
    cols = dict(good)
    cols["cnt"] = cols["cnt"].cpu()
    with pytest.raises(ValueError):
        decide_cuda.decide_rows(config, flow, occ, fst, ost, now, cols, True)
    with pytest.raises(ValueError):
        decide_cuda.decide_rows(config, flow.transpose(0, 1), occ, fst, ost,
                                now, good, True)


def test_cpu_tensors_take_plain_version_and_do_not_count():
    before = decide_cuda.LAUNCHES["decide_rows"]
    max_err, mismatches, st, statuses, reached = _run("cpu", 200, False,
                                                      seed=3)
    assert not mismatches and max_err == 0.0
    assert reached == set(DC.COVERAGE), reached
    assert decide_cuda.LAUNCHES["decide_rows"] == before
    assert int(st.flow.counts.sum()) > 0
    seen = set(torch.cat(statuses).tolist())
    # the tight namespace's guard is crossed; shaping and occupy answer
    assert {0, 1, 2, 4} <= seen, seen


def test_zipf_and_batches_are_seeded():
    z = DC.ZipfIds(1000, alpha=1.1)
    a = z(np.random.default_rng(1), 5000)
    b = z(np.random.default_rng(1), 5000)
    assert np.array_equal(a, b) and a.min() >= 0 and a.max() < 1000
    # rank 0 is the hottest id
    assert np.bincount(a).argmax() == 0
    cfg = EngineConfig(max_flows=1000, batch_size=256)
    batch = DC.grouped_batch(cfg, np.random.default_rng(2), z, 200, False,
                             unknown=5)
    slots = batch.flow_slot[:200]
    assert np.all(slots[:-1] <= slots[1:]) and (slots == -1).sum() == 5
    assert batch.valid.sum() == 200
