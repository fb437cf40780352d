"""The CUDA kernels (decide, count-min, SALSA, segment prefix) against their
plain PyTorch versions.

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
from sentinel_tpu_torch.engine.param import (  # noqa: E402
    ParamConfig,
    make_param_state,
)
from sentinel_tpu_torch.engine.state import make_state  # noqa: E402
from sentinel_tpu_torch.ops import (  # noqa: E402
    cms_cuda,
    decide_cuda,
    prefix_cuda,
    salsa_cuda,
)
import torch_kernel_check as DC  # noqa: E402
import torch_param_check as PC  # noqa: E402


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
@pytest.mark.parametrize("N", [64, 1025, 4095])
@pytest.mark.parametrize("uniform", [True, False])
def test_kernel_matches_plain_on_shaped_batches(cuda, N, uniform):
    """Batches shaped against the grid of segment-owning blocks, each step
    launched five times from the same state."""
    cfg, rng, table, state = _setup(cuda, N=N, seed=N)
    _, chunk = decide_cuda.launch_grid(N)
    named = DC.adversarial_batches(cfg, rng, chunk, uniform, cfg.max_flows)
    nows = [10_040 + dt for dt in DC.STEP_OFFSETS_MS]
    max_err, mismatches, _, _, _ = DC.check_steps(
        cfg, table, state, [b for _, b in named], nows, uniform, repeats=5)
    torch.cuda.synchronize()
    assert not mismatches, mismatches[:10]
    assert max_err == 0.0


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


PARAM_LAUNCHES = {"cms": (cms_cuda.LAUNCHES, "cms_decide_update"),
                  "salsa": (salsa_cuda.LAUNCHES, "salsa_decide_update")}


@pytest.mark.gpu
@pytest.mark.parametrize(
    "N", [1, 8, 32, 33, 64, 65, 300, 2048, 4097, 8192, 8193])
@pytest.mark.parametrize("sketch", ["cms", "salsa"])
def test_param_kernel_matches_plain(cuda, sketch, N):
    """Every admission path and its edges: one warp (32 and 64 rows), the
    sort in shared memory, in the global workspace above 8192 rows; the
    steps roll written buckets."""
    cfg = ParamConfig(sketch=sketch)
    counter, name = PARAM_LAUNCHES[sketch]
    before = counter[name]
    batches, nows = PC.kernel_batches(cfg, N, seed=N)
    r = PC.check_param_steps(cfg, make_param_state(cfg, device=cuda),
                             batches, nows)
    torch.cuda.synchronize()
    assert not r.mismatches, r.mismatches[:10]
    assert r.max_abs_err == 0.0
    assert counter[name] - before == len(nows)
    assert r.reached == set(PC.coverage_for(sketch, N)), r.reached
    assert "rolled_written_bucket" in r.reached


@pytest.mark.gpu
@pytest.mark.parametrize("N", [8, 64, 1024])
@pytest.mark.parametrize("twin", ["primary", "standby", "off"])
def test_param_kernel_carries_the_slim_twin(cuda, twin, N):
    """The count-min launch with the slim twin inside, bitwise against the
    torch-op composition around the plain core on copies of one state:
    a primary (no bucket authoritative), a standby (one bucket flagged, then
    rolled stale: its slim column zeroed, its flag dropped), the twin off
    (``slim_width=0``: the same kernel's plain path). Every step has rows
    without a rule, padded rows and repeated values."""
    cfg = ParamConfig(slim_width=0) if twin == "off" else ParamConfig()
    batches, nows = PC.kernel_batches(cfg, N, seed=N)
    before = dict(cms_cuda.LAUNCHES)
    r = PC.check_param_steps(cfg, PC.twin_state(cfg, twin, cuda, seed=N),
                             PC.with_twin(cfg, batches), nows,
                             fns=PC.twin_fns(cfg))
    torch.cuda.synchronize()
    assert not r.mismatches, r.mismatches[:10]
    assert r.max_abs_err == 0.0
    assert cms_cuda.LAUNCHES["cms_decide_update"] - \
        before["cms_decide_update"] == len(nows)
    assert cms_cuda.LAUNCHES["cms_slim_fused"] - before["cms_slim_fused"] \
        == (0 if twin == "off" else len(nows))
    want = set(PC.COVERAGE) | set(PC.TWIN_COVERAGE[twin])
    assert want <= r.reached, want - r.reached


def _param_service(device, **param):
    from sentinel_tpu_torch.cluster.token_service import (
        ClusterParamFlowRule,
        DefaultTokenService,
    )

    svc = DefaultTokenService(
        EngineConfig(max_flows=64, max_namespaces=4, batch_size=256),
        param_config=ParamConfig(max_param_rules=16, width=128, **param),
        device=device)
    svc.load_param_rules([ClusterParamFlowRule(7, 50.0)])
    return svc


def _device_ops(fn):
    """The names of the device operations ``fn()`` runs (its result
    synchronised before the trace ends)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if str(e.device_type()) == "DeviceType.CUDA"]


def _count_slim_steps(monkeypatch, fail: bool):
    from sentinel_tpu_torch.sketch import slim

    calls = []
    for name in ("slim_prestep", "slim_poststep"):
        orig = getattr(slim, name)

        def step(*a, _orig=orig, _name=name, **k):
            if fail:
                raise AssertionError(f"{_name} ran as torch ops")
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(slim, name, step)
    return calls


@pytest.mark.gpu
def test_param_request_is_one_upload_one_launch_one_read(cuda, monkeypatch):
    svc = _param_service(cuda)
    svc.request_params_token(7, 1, [11, 12, 13])  # builds, warms
    torch.cuda.synchronize()
    _count_slim_steps(monkeypatch, fail=True)
    before = dict(cms_cuda.LAUNCHES)
    out = []
    ops = _device_ops(
        lambda: out.append(svc.request_params_token(7, 2, [11, 14])))
    assert int(out[0].status) == 0
    assert len(ops) == 3, ops
    assert sum("cms_decide_kernel" in n for n in ops) == 1, ops
    assert sum("HtoD" in n for n in ops) == 1, ops
    assert sum("DtoH" in n for n in ops) == 1, ops
    for name in ("cms_decide_update", "cms_slim_fused"):
        assert cms_cuda.LAUNCHES[name] - before[name] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("param", [dict(sketch="salsa"), dict(impl="jax")])
def test_salsa_and_torch_ops_keep_the_composition(cuda, monkeypatch, param):
    svc = _param_service(cuda, **param)
    calls = _count_slim_steps(monkeypatch, fail=False)
    before = cms_cuda.LAUNCHES["cms_slim_fused"]
    assert int(svc.request_params_token(7, 1, [11, 12]).status) == 0
    assert calls == ["slim_prestep", "slim_poststep"]
    assert cms_cuda.LAUNCHES["cms_slim_fused"] == before


@pytest.mark.gpu
def test_param_wrappers_reject_bad_inputs(cuda):
    cfg = ParamConfig(max_param_rules=8, width=64)
    st = make_param_state(cfg, device=cuda)
    cols = PC.to_device(PC.kernel_batches(cfg, 16, seed=0)[0][0], cuda)
    args = [cols[k] for k in ("rule_slot", "idx", "acquire", "threshold",
                              "valid")]
    bad = list(args)
    bad[2] = bad[2].to(torch.int64)
    with pytest.raises(TypeError):
        cms_cuda.cms_decide_update(st.counts, st.starts, *bad, 1000, 500)
    bad = list(args)
    bad[3] = bad[3].cpu()
    with pytest.raises(ValueError):
        cms_cuda.cms_decide_update(st.counts, st.starts, *bad, 1000, 500)
    with pytest.raises(TypeError):  # a count-min plane is not SALSA's
        salsa_cuda.salsa_decide_update(st.counts, st.starts, st.merges,
                                       *args, 1000, 500)
    with pytest.raises(ValueError):
        prefix_cuda.segment_prefix(args[0][::2], args[3][::2])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n", [1, 31, 32, 33, 1025, 5000, 16384, 16385, 65536])
def test_prefix_kernel_matches_plain(cuda, n):
    """The plan kernel bitwise against its plain version and the apply
    kernel against the mask form, on every key shape; the edges of the
    one-block plan (16384 rows) and apply (1024 items)."""
    rng = np.random.default_rng(n)
    for shape, keys_np in DC.prefix_key_shapes(rng, n).items():
        keys = torch.as_tensor(keys_np, device=cuda)
        contrib = torch.as_tensor(rng.integers(0, 4, n).astype(np.float32),
                                  device=cuda)
        before = dict(prefix_cuda.LAUNCHES)
        plan = prefix_cuda.segment_prefix_plan(keys)
        got = prefix_cuda.segment_prefix_apply(plan, contrib)
        torch.cuda.synchronize()
        want_plan = prefix_cuda.segment_prefix_plan_plain(keys)
        assert torch.equal(plan.order, want_plan.order), shape
        assert torch.equal(got, prefix_cuda.segment_prefix_plain(
            keys, contrib)), shape
        assert {k: v - before[k] for k, v in prefix_cuda.LAUNCHES.items()} \
            == {"segment_prefix_plan": 1, "segment_prefix_apply": 1}


@pytest.mark.gpu
def test_wrappers_never_sort_with_a_library_call(cuda, monkeypatch):
    """On CUDA tensors the plan, the apply and the param kernels' wrappers
    reach no library sort."""
    def refuse(*args, **kwargs):
        raise AssertionError("a library sort was called")

    for name in ("sort", "argsort", "msort"):
        monkeypatch.setattr(torch, name, refuse, raising=False)
        monkeypatch.setattr(torch.Tensor, name, refuse, raising=False)
    rng = np.random.default_rng(2)
    keys = torch.as_tensor(rng.integers(-5, 5, 3000).astype(np.int32),
                           device=cuda)
    contrib = torch.ones(3000, device=cuda)
    prefix_cuda.segment_prefix(keys, contrib)
    for sketch in ("cms", "salsa"):
        cfg = ParamConfig(sketch=sketch)
        kernel, _ = PC.step_fns(sketch)
        cols = PC.to_device(PC.kernel_batches(cfg, 3000, seed=1)[0][0], cuda)
        kernel(make_param_state(cfg, device=cuda), cols, 20_040,
               cfg.bucket_ms)
    torch.cuda.synchronize()


def test_param_batches_are_seeded_and_shaped():
    cfg = ParamConfig(max_param_rules=16, width=64, sketch="salsa")
    a, nows = PC.kernel_batches(cfg, 64, seed=4)
    b, _ = PC.kernel_batches(cfg, 64, seed=4)
    assert nows[-1] - nows[0] > 2 * cfg.interval_ms
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    cols = a[0]
    assert cols["idx"].shape == (64, cfg.depth)
    assert cols["idx"].max() < cfg.cell_width and cols["idx"].min() >= 0
    assert (~cols["valid"]).any() and (cols["rule_slot"] < 0).any()
    assert int(cols["acquire"].sum()) < 2**24  # the prefix precondition


@pytest.mark.parametrize("n", [1, 31, 64, 1025, 16383, 16384, 65536, 10**6])
def test_launch_grid_tiles_the_batch(n):
    blocks, chunk = decide_cuda.launch_grid(n)
    assert chunk >= decide_cuda.MIN_CHUNK
    assert blocks <= decide_cuda.SM_COUNT
    assert (blocks - 1) * chunk < n <= blocks * chunk


def _cuts_at_heads(slots, chunk):
    """Row ranges that tile the batch, cut at the first segment head at or
    after each multiple of ``chunk`` (what the kernel's blocks own)."""
    n = slots.size
    heads = np.concatenate([[True], slots[1:] != slots[:-1]])
    at = np.nonzero(heads)[0]
    cuts = [0]
    for b in range(chunk, n, chunk):
        later = at[at >= b]
        cut = int(later[0]) if later.size else n
        if cut > cuts[-1]:
            cuts.append(cut)
    return list(zip(cuts, cuts[1:] + [n]))


@pytest.mark.parametrize("seed", [0, 1])
def test_segments_are_independent(seed):
    """The property the multi-block kernel rests on: with mixed acquires,
    on a step that does not roll, ``decide_rows_plain`` run range by range
    on a grouped batch cut at segment heads gives bitwise the rows and the
    flow plane of one whole call.

    Two things are batch-wide and excluded here. On a rolling step the
    first range's call would zero the column and record the new start, and
    the later ranges would compute their window masks from that new start
    (the kernel takes the masks from the pre-roll starts in its first
    launch). The uniform form's ``a`` is the max of the live acquires of
    the whole batch (the kernel reduces it in its first launch). The batch
    is not padded: padding rows map onto flow row 0 at the batch's end and
    would read it after the first range wrote it (the kernel reads that one
    cell from a snapshot)."""
    N = 600
    cfg, rng, table, state = _setup("cpu", N=N, seed=seed)
    zipf = DC.ZipfIds(cfg.max_flows)
    now = 10_040
    for dt in (0, 5):  # fill the window; the second step does not roll
        batch = DC.grouped_batch(cfg, rng, zipf, N, False, unknown=7)
        state, _ = decide_cuda.decide_core_kernel(
            cfg, state, table, batch, now + dt, grouped=True, uniform=False)
    batch = DC.grouped_batch(cfg, rng, zipf, N, False, unknown=7)
    config, flow, occ, fst, ost, t, cols, uniform = DC.kernel_args(
        cfg, table, DC.clone_state(state), batch, now + 9, uniform=False)
    flow, fst = state.flow.counts, state.flow.starts
    idx_cur = (t // cfg.bucket_ms) % cfg.n_buckets
    assert int(fst[idx_cur]) == t - t % cfg.bucket_ms  # no roll
    assert int(flow[:, idx_cur].sum()) > 0

    flow_w, fst_w = flow.clone(), fst.clone()
    whole = decide_cuda.decide_rows_plain(config, flow_w, occ, fst_w, ost, t,
                                          cols, uniform)
    flow_c, fst_c = flow.clone(), fst.clone()
    ranges = _cuts_at_heads(cols["safe_slot"].numpy(), 32)
    assert len(ranges) > 8
    parts = [
        decide_cuda.decide_rows_plain(
            config, flow_c, occ, fst_c, ost, t,
            {k: v[a:b] for k, v in cols.items()}, uniform)
        for a, b in ranges
    ]
    for f, want in zip(whole._fields, whole):
        got = torch.cat([getattr(p, f) for p in parts])
        assert torch.equal(got, want), f
    assert torch.equal(flow_c, flow_w) and torch.equal(fst_c, fst_w)
    assert not torch.equal(flow_w, flow)
    assert bool(whole.admit.any()) and bool((~whole.admit).any())


@pytest.mark.parametrize("N", [64, 200, 1025, 3000])
@pytest.mark.parametrize("uniform", [True, False])
def test_shaped_batches_reach_every_case(N, uniform):
    """The batches shaped against the kernel's grid are seeded, reach every
    shape a batch of their size can, and pass the repeat check against the
    plain version on the CPU."""
    cfg, rng, table, state = _setup("cpu", N=N, seed=N)
    F = cfg.max_flows
    _, chunk = decide_cuda.launch_grid(N)
    named = DC.adversarial_batches(cfg, rng, chunk, uniform, F)
    again = DC.adversarial_batches(
        cfg, _setup("cpu", N=N, seed=N)[1], chunk, uniform, F)
    shapes = set()
    for (name, a), (_, b) in zip(named, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)
        slots = np.asarray(a.flow_slot)[np.asarray(a.valid)]
        assert np.all(slots[:-1] <= slots[1:]), name  # grouped
        shapes |= DC.shape_coverage(cfg, a, chunk, F)
    assert shapes == DC.required_shapes(N)
    nows = [10_040 + dt for dt in DC.STEP_OFFSETS_MS]
    max_err, mismatches, _, statuses, reached = DC.check_steps(
        cfg, table, state, [b for _, b in named], nows, uniform, repeats=2)
    assert not mismatches and max_err == 0.0
    assert "rolled_written_column" in reached
    assert {0, 1} <= set(torch.cat(statuses).tolist())


def test_repeat_check_catches_a_launch_that_differs(monkeypatch):
    cfg, rng, table, state = _setup("cpu", N=64, seed=5)
    zipf = DC.ZipfIds(cfg.max_flows)
    batch = DC.grouped_batch(cfg, rng, zipf, 64, False)
    plain, calls = decide_cuda.decide_rows_plain, []

    def flaky(*args):
        out = plain(*args)
        calls.append(1)
        if len(calls) == 2:  # the first repeat of the kernel side
            out = out._replace(passed=out.passed + 1.0)
        return out

    monkeypatch.setattr(decide_cuda, "decide_rows", flaky)
    _, mismatches, _, _, _ = DC.check_steps(cfg, table, state, [batch],
                                            [10_040], False, repeats=3)
    assert mismatches == ["step 0: repeat 1 differs in ['passed']"]


@pytest.mark.parametrize("N", [1, 8, 33, 64, 65, 300])
@pytest.mark.parametrize("sketch", ["cms", "salsa"])
def test_param_workloads_reach_every_case(sketch, N):
    """On the CPU the wrappers run the plain versions: the seeded steps
    reach every coverage case, the SALSA pair cases included, and every pair
    no admitted row addressed keeps its bits."""
    cfg = ParamConfig(max_param_rules=16, width=128, sketch=sketch)
    batches, nows = PC.kernel_batches(cfg, N, seed=N)
    r = PC.check_param_steps(cfg, make_param_state(cfg, device="cpu"),
                             batches, nows)
    assert not r.mismatches and r.max_abs_err == 0.0
    assert r.reached == set(PC.coverage_for(sketch, N)), \
        set(PC.coverage_for(sketch, N)) - r.reached
    assert r.admitted > 0 and (r.blocked > 0 or N < 8)


def test_untouched_pair_check_has_teeth():
    cfg = ParamConfig(max_param_rules=16, width=128, sketch="salsa")
    st = make_param_state(cfg, device="cpu")
    cols = PC.to_device(PC.kernel_batches(cfg, 64, seed=1)[0][0], "cpu")
    plane0 = st.counts[:, 0].clone()
    admit = cols["valid"] & (cols["rule_slot"] >= 0)
    assert PC.untouched_pairs_equal(plane0, plane0.clone(), cols, admit)
    addressed = plane0.clone()
    row = int(torch.nonzero(admit)[0])
    addressed[cols["rule_slot"][row], 0, cols["idx"][row, 0]] += 1
    assert PC.untouched_pairs_equal(plane0, addressed, cols, admit)
    stray = plane0.clone()
    free = torch.ones(cfg.cell_width, dtype=torch.bool)
    free[(cols["idx"][:, 0].long() // 2) * 2] = False
    free[(cols["idx"][:, 0].long() // 2) * 2 + 1] = False
    stray[0, 0, int(torch.nonzero(free)[0])] += 1
    assert not PC.untouched_pairs_equal(plane0, stray, cols, admit)


@pytest.mark.parametrize("twin", ["primary", "standby", "off"])
def test_twin_check_runs_on_the_cpu(twin):
    """The twin's check on the CPU, where both sides compose the torch-op
    steps (nothing fused, nothing counted): its states, indices and
    coverage reach every case the card's test asks for."""
    cfg = ParamConfig(max_param_rules=16, width=128,
                      **({"slim_width": 0} if twin == "off" else {}))
    batches, nows = PC.kernel_batches(cfg, 64, seed=5)
    before = dict(cms_cuda.LAUNCHES)
    r = PC.check_param_steps(cfg, PC.twin_state(cfg, twin, "cpu"),
                             PC.with_twin(cfg, batches), nows,
                             fns=PC.twin_fns(cfg))
    assert not r.mismatches and r.max_abs_err == 0.0
    assert cms_cuda.LAUNCHES == before
    want = set(PC.COVERAGE) | set(PC.TWIN_COVERAGE[twin])
    assert want <= r.reached, want - r.reached


def _old_columns(pc, slot, count, items, acquire, hashes):
    """A request's columns as the service built them before they shared
    one staging block: each padded on its own."""
    from sentinel_tpu_torch.engine.param import hash_indices
    from sentinel_tpu_torch.sketch.slim import slim_indices

    hashes = np.asarray(hashes, dtype=np.int64)
    n = hashes.shape[0]
    n_pad = max(8, 1 << (n - 1).bit_length())
    pad = n_pad - n
    idx = np.pad(hash_indices(hashes, pc.depth, pc.cell_width),
                 ((0, pad), (0, 0)))
    thr = np.pad(np.array([items.get(int(h), count) for h in hashes],
                          dtype=np.float32), (0, pad))
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True
    idx_slim = (torch.as_tensor(np.pad(slim_indices(pc, hashes),
                                       ((0, pad), (0, 0))))
                if pc.slim_enabled else None)
    return (torch.full((n_pad,), slot, dtype=torch.int32),
            torch.as_tensor(idx),
            torch.full((n_pad,), acquire, dtype=torch.int32),
            torch.as_tensor(thr), torch.as_tensor(valid), idx_slim)


@pytest.mark.parametrize("slim_width", [256, 0])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_staging_block_views_equal_the_padded_columns(n, slim_width):
    from sentinel_tpu_torch.engine.param import stage_rows
    from sentinel_tpu_torch.sketch.slim import slim_indices
    from sentinel_tpu_torch.engine.param import hash_indices

    pc = ParamConfig(max_param_rules=16, width=128, slim_width=slim_width)
    rng = np.random.default_rng(n)
    hashes = rng.integers(-2**62, 2**62, n)
    items = {int(hashes[0]): 3.0}
    old = _old_columns(pc, 5, 50.0, items, 2, hashes)
    rows = stage_rows(
        5, 2, hash_indices(hashes, pc.depth, pc.cell_width),
        np.array([items.get(int(h), 50.0) for h in hashes], np.float32),
        slim_indices(pc, hashes) if pc.slim_enabled else None, 8, "cpu")
    assert len(rows) == len(old)
    for got, want, name in zip(rows, old, rows._fields):
        if want is None:
            assert got is None, name
            continue
        assert got.dtype == want.dtype and torch.equal(got, want), name
    # views into one block
    base = rows.rule_slot.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for t in rows if t is not None)


def test_cpu_service_verdicts_and_state_stay_as_they_were(monkeypatch):
    """A fixed request stream through the CPU service's staged step against
    the same stream built column by column as before, through
    ``param_decide`` on a mirror state: every verdict and every state leaf
    equal."""
    from sentinel_tpu_torch.cluster.token_service import (
        ClusterParamFlowRule,
        DefaultTokenService,
    )
    from sentinel_tpu_torch.core import clock as t_clock
    from sentinel_tpu_torch.engine.decide import TokenStatus
    from sentinel_tpu_torch.engine.param import param_decide

    clock = t_clock.ManualClock(1_700_000_000_000)
    prev = t_clock.set_clock(clock)
    try:
        pc = ParamConfig(max_param_rules=16, width=128)
        svc = DefaultTokenService(
            EngineConfig(max_flows=16, max_namespaces=4, batch_size=16),
            pc, device="cpu")
        rng = np.random.default_rng(31)
        specs = PC.service_rule_specs(12, rng)
        svc.load_param_rules([ClusterParamFlowRule(
            s.flow_id, s.count, s.item_thresholds) for s in specs])
        mirror = PC.clone_param_state(svc._param_state)
        nows = []
        orig = svc._engine_now

        def engine_now():
            nows.append(orig())
            return nows[-1]

        monkeypatch.setattr(svc, "_engine_now", engine_now)
        statuses = set()
        for i, (fid, acq, hashes) in enumerate(
                PC.service_stream(specs, rng, 300)):
            slot, count, items = svc._param_rules[fid]
            got = svc.request_params_token(fid, acq, hashes)
            *cols, idx_slim = _old_columns(pc, slot, count, items, acq,
                                           hashes)
            _, admit, _ = param_decide(pc, mirror, *cols, nows[-1],
                                       idx_slim=idx_slim)
            want = int(TokenStatus.OK if bool(admit[:len(hashes)].all())
                       else TokenStatus.BLOCKED)
            assert int(got.status) == want, f"request {i}"
            statuses.add(want)
            # bursts of 100 within one bucket, then into a later one
            clock.advance(1 if (i + 1) % 100 else 400)
        assert statuses == {int(TokenStatus.OK), int(TokenStatus.BLOCKED)}
        for f, x, y in zip(mirror._fields, svc._param_state, mirror):
            assert torch.equal(x, y), f
        assert len(nows) == 300
    finally:
        t_clock.set_clock(prev)
