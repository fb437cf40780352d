#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sentinel_tpu_torch/csrc`` (one
``nvcc`` per source, started together), then:

1. holds the decide kernel against its plain PyTorch version on the card,
   bitwise (``torch.equal``), at F=100k flows, 64 namespaces, 10 buckets and
   N = 64 / 1024 / 16384 rows, uniform and mixed acquires, over steps that
   cross a namespace guard and span two seconds, so that the 1 s ring wraps
   onto written columns (rolled and masked) and reads expiring buckets
   (``tests/torch_kernel_check.py`` holds the workloads); then on batches
   shaped against the kernel's grid of segment-owning blocks (heads at and
   beside the blocks' bounds, blocks without a head, segments longer than a
   tile and than a block's range, one flow, a flow per row, rows without a
   rule beside slot 0, a padded tail) at N = 64 / 1025 / 16383 / 16384;
   every step is launched 10 times from the same input state and every
   repeat must be bitwise equal;
2. times the kernel and the plain version at those N with CUDA events, and
   at N=16384 also on the one-flow and the flow-per-row batch; prints the
   grid;
3. drives the service path at full size: ``DefaultTokenService`` with 100k
   flow rules (a shaped subset among them), warmed up, answering
   bounded-Zipf (alpha 1.1) pulls of 64, 1024, 16384 and 65536 rows (the
   last takes the fused depth-4 path) over more than three seconds of
   engine clock; its verdicts must equal those of a second service on the
   torch-ops pipeline, fed the same pulls at the same engine clock, and the
   kernel's launch count must rise by exactly one per device step; after
   every other phase, five more 16384-row pulls of that service under
   ``torch.profiler`` give the device time of a pull and the decide
   kernel's share of it (last, so that the profiler's lasting cost on the
   host's launches enters no other phase's times);
4. holds the CMS and SALSA param kernels against their plain versions,
   bitwise, at the service's default sketch (256 rules, depth 2, width
   2048, two 500 ms buckets) and N = 1 / 8 / 32 / 33 / 64 / 65 / 300 /
   1024 / 2048 / 4096 / 4097 / 9000 (each admission path: one warp up to 64
   rows, the sort in shared memory up to 8192, in the global workspace
   above), over seven steps spanning 2.7 s that roll written buckets, mask
   aged ones, reject rows by the in-batch prefix alone and merge SALSA
   pairs, with admitted rows on both cells of one unmerged pair (staying
   unmerged, and merged by their summed adds), on both indices of a merged
   pair, and acquiring 0 (below 8 rows, one row a step: what one row can
   reach); every SALSA pair no admitted row addressed must keep its bits
   (``tests/torch_param_check.py`` holds the workloads); then times them at
   N = 8 / 64 / 1024 / 4096, a step that does not roll and, apart, steps
   that each roll (zeroing the 4 MiB current plane in the same launch);
5. drives the hot-param path: per sketch, a service on the kernel and one on
   the torch-ops core answer the same ``request_params_token`` stream (256
   rules, Zipf values, one reload that frees and reuses slots) over more
   than two seconds of engine clock with equal verdicts and sketches, one
   kernel launch per request, and host p50 / p99 per request;
6. holds the segment-prefix plan kernel bitwise against its plain version
   and the apply kernel against the mask form, at N = 1 / 31 / 32 / 33 /
   1025 / 5000 / 16384 / 16385 / 65536 on every key shape of
   ``torch_kernel_check.prefix_key_shapes`` (Zipf flow ids, one key, a key
   per row, keys equal in their low 8 or 16 bits, negative keys with the
   int32 extremes); times the plan and the apply at N = 64 / 1024 / 16384;
   runs one ungrouped decide step at F=100k with ``prefix_impl="pallas"``
   that must equal the ``"sort"`` step in verdicts and every state leaf, and
   times its prefix work (one plan, its 13 applies) with CUDA events;
7. after every other phase, besides phase 3's profiled pulls, traces 20
   ``request_params_token`` calls per sketch and counts the CUDA kernels
   each call launched, the param kernel's apart from the torch ops around
   it: exactly one param kernel a call;
8. drives completion reports and circuit breaking at the flow
   configuration of phase 3 with 10,000 breakers (every 10th flow; slow
   ratio, error ratio and error count in turn; a third of them sick): a
   service on the decide kernel and one with ``decide_impl="xla"`` take the
   same seeded stream (``tests/torch_outcome_check.py``) over more than 8 s
   of engine clock, each round pulls of 64, 1024, 16384 and a fused 65536
   rows interleaved with ``report_outcomes`` batches of 64, 1024 and 16384
   rows (about 1% invalid). Verdicts and report counts must be equal at
   every step, the flow, outcome and breaker planes (every plane) at the
   end of every round, ``breaker_stats`` every round and ``outcome_stats``
   at the end; the stream must trip, probe, close and reopen breakers, and
   the decide kernel must launch once per device step; then a lease
   sequence on 1,000 flows (grant, pull, renew, return, expiry) must give
   equal results and flow planes; then it times ``report_outcomes`` (host
   p50 / p99) and the outcome step (CUDA events, with and without the
   breaker columns, beside its byte bound), after checking under torch's
   sync debug mode that the step makes no call that waits for the device;
   after every other phase a traced report counts the CUDA kernels a report
   launches;
9. prints the timings, the card's name and power limit, one
   ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.

Any failed check raises and exits non-zero. With no CUDA device, or run from
a directory without the package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F, NS, B = 100_000, 64, 10
SIZES = (64, 1024, 16384)  # the serve ladder's ends and middle
SHAPED_SIZES = (64, 1025, 16383, 16384)  # batches shaped against the grid
REPEATS = 10  # launches per parity step, all bitwise equal
PULLS = (64, 1024, 16384, 65536)  # the last: 4 full frames, fused depth 4
FUSED_DEPTH = 4
# engine-clock ms between served pulls, cycled: same bucket, a roll, a
# short step and a near-full window, so each round spans 1.1 s of the ring
ADVANCES_MS = (5, 130, 45, 930)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores
PARAM_SIZES = (8, 64, 1024, 4096)  # 8: what request_params_token sends
# every admission path and its edges: one warp (<= 32, <= 64 rows), the sort
# in shared memory (<= 8192), in the global workspace (above)
PARAM_CHECK_SIZES = (1, 8, 32, 33, 64, 65, 300, 1024, 2048, 4096, 4097, 9000)
PREFIX_SIZES = (64, 1024, 16384)
# the one-block edges of the plan (16384) and the apply (1024 items)
PREFIX_CHECK_SIZES = (1, 31, 32, 33, 1025, 5000, 16384, 16385, 65536)
PROFILED_PARAM_CALLS = 20
PARAM_REQUESTS = 600  # per sketch, half before and half after a reload
PARAM_ADVANCES_MS = (1, 2, 4, 9)  # engine clock between param requests
SKETCHES = ("cms", "salsa")
# phase 8: one round of pulls and reports (a fused 4-frame pull), 500 ms of
# engine clock; 17 rounds span 8.5 s
OUTCOME_PLAN = (("pull", 64), ("report", 64), ("pull", 1024),
                ("report", 1024), ("pull", 16384), ("report", 16384),
                ("pull", 4 * 16384), ("report", 16384))
OUTCOME_ADVANCES_MS = (20, 60, 35, 90, 45, 120, 60, 70)
OUTCOME_ROUNDS = 17
REPORT_SIZES = (64, 1024, 16384)
LEASE_FLOWS = 1000


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device ms per call of ``fn`` over ``reps`` calls (warmed).

    A sleep kernel holds the stream while the host enqueues the calls, so
    the events bracket device work only, not the host's launch overhead
    (which :func:`host_ms` reports)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    per_call_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # ~2 GHz: cycles for twice the host time the enqueue loop needs
    torch.cuda._sleep(int(min(2.0 * reps * per_call_s, 5.0) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int, torch) -> float:
    """Mean wall ms per call of ``fn``, each call synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def decide_bytes(cols, out, rows_touched: int, tails: int,
                 stale_rows: int) -> int:
    """Bytes the decide step must move: each distinct flow row's [B, E]
    window and [B] occupy row read once, every [N] input column read once,
    every [N] output written once, one [E] write per segment tail, and the
    stale column zeroed when the ring rolls."""
    col_bytes = sum(t.numel() * t.element_size() for t in cols.values())
    out_bytes = sum(t.numel() * t.element_size() for t in out)
    return (rows_touched * B * (6 + 1) * 4 + col_bytes + out_bytes
            + tails * 6 * 4 + stale_rows * 6 * 4)


def phase_parity(torch, dev, cfg, table, state):
    """Kernel vs plain version, bitwise, at every N of the serve ladder."""
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.decide import TokenStatus
    from sentinel_tpu_torch.ops import decide_cuda as K

    rng = np.random.default_rng(2024)
    zipf = DC.ZipfIds(F, alpha=1.1)
    max_err, checked = 0.0, 0
    tight = table.namespace_id[0]  # flow 0, the hottest id, is in it
    for n in SIZES:
        # a guard budget the pulls cross inside the first steps at every N
        table.ns_max_qps[tight] = float(n // 16)
        for uniform in (True, False):
            c = cfg._replace(batch_size=n)
            nows = [30_040 + dt for dt in DC.STEP_OFFSETS_MS]
            batches = [DC.grouped_batch(c, rng, zipf, n, uniform,
                                        unknown=max(1, n // 100))
                       for _ in nows]
            err, bad, _, statuses, reached = DC.check_steps(
                c, table, state, batches, nows, uniform, repeats=REPEATS)
            torch.cuda.synchronize()
            if bad:
                raise AssertionError(
                    f"kernel != plain at N={n} uniform={uniform}: {bad[:8]}"
                )
            if reached != set(DC.COVERAGE):
                raise AssertionError(
                    f"N={n} uniform={uniform}: the steps reached only "
                    f"{sorted(reached)} of {DC.COVERAGE}"
                )
            max_err = max(max_err, err)
            checked += len(nows)
            seen = torch.bincount(torch.cat(statuses).long().cpu(),
                                  minlength=len(TokenStatus))
            hist = {TokenStatus(i).name: int(c)
                    for i, c in enumerate(seen.tolist()) if c}
            if not seen[int(TokenStatus.TOO_MANY_REQUEST)]:
                raise AssertionError(f"N={n}: the namespace guard never "
                                     f"crossed: {hist}")
            log(f"parity N={n} uniform={uniform}: {len(nows)} steps x "
                f"{REPEATS} launches bitwise equal, ring wrapped onto "
                f"written columns; verdicts {hist}")
    for n in SHAPED_SIZES:
        blocks, chunk = K.launch_grid(n)
        c = cfg._replace(batch_size=n)
        for uniform in (True, False):
            named = DC.adversarial_batches(c, rng, chunk, uniform, F)
            nows = [40_040 + dt for dt in DC.STEP_OFFSETS_MS]
            shapes = set()
            for _, batch in named:
                shapes |= DC.shape_coverage(c, batch, chunk, F)
            missing = DC.required_shapes(n) - shapes
            if missing:
                raise AssertionError(
                    f"N={n} uniform={uniform}: the shaped batches never "
                    f"reached {sorted(missing)}")
            err, bad, _, _, reached = DC.check_steps(
                c, table, state, [b for _, b in named], nows, uniform,
                repeats=REPEATS)
            torch.cuda.synchronize()
            if bad:
                raise AssertionError(
                    f"kernel != plain on shaped batches at N={n} "
                    f"uniform={uniform}: {bad[:8]}")
            if "rolled_written_column" not in reached:
                raise AssertionError(f"N={n}: no shaped step rolled a "
                                     f"written column")
            max_err = max(max_err, err)
            checked += len(nows)
            log(f"parity shaped N={n} uniform={uniform} grid {blocks} x "
                f"{chunk} rows: {[name for name, _ in named]} x {REPEATS} "
                f"launches bitwise equal; reached {sorted(shapes)}")
    return max_err, checked


def phase_timing(torch, dev, cfg, table, state):
    """Kernel and plain-version ms per step, with the byte bound."""
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.state import clone_state
    from sentinel_tpu_torch.ops import decide_cuda as K

    rng = np.random.default_rng(7)
    zipf = DC.ZipfIds(F, alpha=1.1)

    def time_batch(label, n, batch):
        c = cfg._replace(batch_size=n)
        args = DC.kernel_args(c, table, clone_state(state), batch, 50_010,
                              uniform=True)
        cols = args[6]
        kernel_ms = cuda_ms(lambda: K.decide_rows(*args), 50, torch)
        plain_ms = cuda_ms(lambda: K.decide_rows_plain(*args), 5, torch)
        kernel_wall = host_ms(lambda: K.decide_rows(*args), 20, torch)
        out = K.decide_rows(*args)
        slots = cols["safe_slot"].cpu().numpy()
        touched = int(np.unique(slots).size)
        tails = int(cols["write_ok"].sum())
        nbytes = decide_bytes(cols, out, touched, tails, stale_rows=0)
        ops = 60 * n  # per-row admission arithmetic, a few dozen flops
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       ops / PEAK_F32_OPS_PER_S) * 1e3
        blocks, chunk = K.launch_grid(n)
        longest = int(np.bincount(slots).max())
        log(f"timing {label} N={n}: kernel {kernel_ms:.4f} ms on the device "
            f"({kernel_wall:.4f} ms a call with host launch), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
            f"({nbytes} B, {touched} distinct flows, longest segment "
            f"{longest} rows); grid {blocks} blocks, {chunk} nominal rows a "
            f"block")
        return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    wall_ms=kernel_wall, bytes=nbytes,
                    rows_touched=touched, longest_segment=longest,
                    blocks=blocks)

    rows = {}
    for n in SIZES:
        c = cfg._replace(batch_size=n)
        batch = DC.grouped_batch(c, rng, zipf, n, uniform=True,
                                 unknown=max(1, n // 100))
        rows[n] = time_batch("zipf", n, batch)
    # the two extremes of segment length at the largest N
    n = SIZES[-1]
    c = cfg._replace(batch_size=n)
    for label, heads in (("one_flow", np.zeros(n, bool)),
                         ("all_distinct", np.ones(n, bool))):
        batch = DC.batch_from_heads(c, rng, heads, True, F)
        rows[n][label] = time_batch(label, n, batch)
    return rows


def service_rules(ClusterFlowRule, ThresholdMode):
    """100k rules as the repo's bench builds them, with a shaped subset."""
    rules = []
    for i in range(F):
        beh = 1 if i % 97 == 0 else 2 if i % 89 == 0 else \
            3 if i % 83 == 0 else 0
        rules.append(ClusterFlowRule(
            flow_id=i, count=100.0 + (i % 100), mode=ThresholdMode.GLOBAL,
            namespace=f"ns{i % 64}", control_behavior=beh,
        ))
    return rules


def phase_service(torch, dev):
    """The service path at full size, kernel vs torch-ops pipeline."""
    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine import (
        ClusterFlowRule,
        EngineConfig,
        ThresholdMode,
    )
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.decide import TokenStatus
    from sentinel_tpu_torch.ops import decide_cuda as K

    mc = clock.ManualClock(1_700_000_000_000)
    prev = clock.set_clock(mc)
    try:
        cfg = EngineConfig(max_flows=F, max_namespaces=NS,
                           batch_size=SIZES[-1])
        rules = service_rules(ClusterFlowRule, ThresholdMode)
        svc = DefaultTokenService(cfg, device=dev)
        ref = DefaultTokenService(cfg._replace(decide_impl="xla"),
                                  device=dev)
        for s in (svc, ref):
            s.load_rules(rules, ns_max_qps=1e9)
            s.warmup()
        zipf = DC.ZipfIds(F, alpha=1.1)
        rng = np.random.default_rng(99)
        pulls = PULLS
        steps_per_round = len(pulls) - 1 + FUSED_DEPTH
        valid = {int(s) for s in TokenStatus}

        # --- the main path, read through the launch count ----------------
        rounds = 3
        t_start = mc.now_ms()
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        advances = itertools.cycle(ADVANCES_MS)
        for r in range(rounds):
            for n in pulls:
                ids = zipf(rng, n)
                acq = None if r % 2 == 0 else rng.integers(1, 3, n).astype(
                    np.int32)
                st, rem, wait = svc.request_batch_arrays(ids, acq)
                st_r, rem_r, wait_r = ref.request_batch_arrays(ids, acq)
                if st.shape != (n,) or not set(np.unique(st)) <= valid:
                    raise AssertionError(f"bad statuses for n={n}")
                for name, a, b in (("status", st, st_r),
                                   ("remaining", rem, rem_r),
                                   ("wait", wait, wait_r)):
                    if not np.array_equal(a, b):
                        raise AssertionError(
                            f"service {name} differs from the torch-ops "
                            f"pipeline at n={n} round={r}"
                        )
                mc.advance(next(advances))
        launches = K.LAUNCHES["decide_rows"]
        spanned = mc.now_ms() - t_start
        if spanned < 2 * cfg.n_buckets * cfg.bucket_ms:
            raise AssertionError(f"the pulls spanned only {spanned} ms")
        if launches != rounds * steps_per_round:
            raise AssertionError(
                f"kernel launched {launches} times for "
                f"{rounds * steps_per_round} device steps"
            )
        log(f"service: {rounds} rounds of pulls {pulls} over {spanned} ms "
            f"equal to the torch-ops pipeline; {launches} kernel launches")

        # --- timing: host clock around each pull (materialized) ----------
        lat = {n: [] for n in pulls}
        for r in range(20):
            for n in pulls:
                ids = zipf(rng, n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc.request_batch_arrays(ids)
                lat[n].append(time.perf_counter() - t0)
                mc.advance(7)
        stats = {}
        for n in pulls:
            a = np.array(lat[n]) * 1e3
            stats[n] = dict(p50_ms=float(np.percentile(a, 50)),
                            p99_ms=float(np.percentile(a, 99)),
                            decisions_per_s=float(n / (a.mean() / 1e3)))
            log(f"service n={n}: p50 {stats[n]['p50_ms']:.3f} ms, p99 "
                f"{stats[n]['p99_ms']:.3f} ms, "
                f"{stats[n]['decisions_per_s']:.0f} decisions/s")

        def profiled_pulls():
            """Left to the end of the run: once the profiler has traced a
            process, its later launches cost the host more."""
            before = clock.set_clock(mc)
            try:
                return pull_device_time(torch, svc, mc, zipf, rng, SIZES[-1])
            finally:
                clock.set_clock(before)

        return launches, stats, profiled_pulls
    finally:
        clock.set_clock(prev)


def pull_device_time(torch, svc, mc, zipf, rng, n: int, pulls: int = 5):
    """Device time of one served ``n``-row pull and the decide kernel's
    share of it, from a ``torch.profiler`` trace of ``pulls`` pulls (device
    rows only, each counted once). The profiler slows the host, so the wall
    time of these pulls is not reported."""
    from torch.profiler import ProfilerActivity, profile

    batches = [zipf(rng, n) for _ in range(pulls)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ids in batches:
            svc.request_batch_arrays(ids)
            mc.advance(7)
        torch.cuda.synchronize()
    total_us = kernel_us = 0.0
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            total_us += evt.self_device_time_total
            if "decide_kernel" in evt.key or "roll_kernel" in evt.key:
                kernel_us += evt.self_device_time_total
    if total_us <= 0.0 or kernel_us <= 0.0:
        raise AssertionError(
            f"service n={n}: the profiler showed {total_us} us of device "
            f"time over {pulls} pulls, {kernel_us} us of it in the decide "
            f"kernel's launches")
    out = dict(device_ms_a_pull=total_us / pulls / 1e3,
               decide_kernel_ms_a_pull=kernel_us / pulls / 1e3)
    log(f"service n={n}: device busy {out['device_ms_a_pull']:.4f} ms a "
        f"pull over {pulls} profiled pulls, of which the decide kernel's two "
        f"launches {out['decide_kernel_ms_a_pull']:.4f} ms "
        f"({100 * kernel_us / total_us:.1f}%)")
    return out


def param_bytes(sketch: str, n: int, depth: int, n_buckets: int,
                admitted: int, touched_pairs: int) -> int:
    """Bytes one param step must move: the [N] columns (slot, D indices,
    acquire, threshold, valid in; admit, estimate out), D x B gathered cells
    (a SALSA cell is read as its 4-byte pair), and the admitted rows' D cell
    writes for count-min, or each touched pair's 4 bytes read and written
    for SALSA (the function re-encodes a whole plane only in name: every
    other pair keeps its bits). The timed steps do not roll (no 4 MiB
    zeroing)."""
    cols = n * (4 + 4 * depth + 4 + 4 + 1 + 1 + 4)
    gathered = n * depth * n_buckets * 4
    if sketch == "salsa":
        return cols + gathered + touched_pairs * 2 * 4
    return cols + gathered + admitted * depth * 4


def phase_param_parity(torch, dev):
    """CMS and SALSA kernels vs their plain versions, bitwise."""
    import torch_param_check as PC

    from sentinel_tpu_torch.engine.param import ParamConfig, make_param_state

    if PC.STEP_OFFSETS_MS[-1] - PC.STEP_OFFSETS_MS[0] <= 2000:
        raise AssertionError("the param steps must span more than 2 s")
    out = {}
    for sketch in SKETCHES:
        cfg = ParamConfig(sketch=sketch)
        max_err, steps = 0.0, 0
        for n in PARAM_CHECK_SIZES:
            batches, nows = PC.kernel_batches(cfg, n, seed=n)
            r = PC.check_param_steps(cfg, make_param_state(cfg, device=dev),
                                     batches, nows)
            torch.cuda.synchronize()
            if r.mismatches:
                raise AssertionError(
                    f"{sketch} kernel != plain at N={n}: {r.mismatches[:8]}"
                )
            missing = set(PC.coverage_for(sketch, n)) - r.reached
            if missing:
                raise AssertionError(
                    f"{sketch} N={n}: the steps never reached "
                    f"{sorted(missing)}")
            max_err = max(max_err, r.max_abs_err)
            steps += len(nows)
            log(f"param parity {sketch} N={n}: {len(nows)} steps over "
                f"{nows[-1] - nows[0]} ms bitwise equal; reached "
                f"{sorted(r.reached)}; {r.admitted} rows admitted, "
                f"{r.blocked} blocked")
        out[sketch] = (max_err, steps)
    return out


def phase_param_timing(torch, dev):
    """Param kernel and plain-version ms per step, with the byte bound."""
    import torch_param_check as PC

    from sentinel_tpu_torch.engine.param import ParamConfig, make_param_state

    out = {}
    for sketch in SKETCHES:
        cfg = ParamConfig(sketch=sketch)
        kernel, plain = PC.step_fns(sketch)
        rows = {}
        for n in PARAM_SIZES:
            batches, nows = PC.kernel_batches(cfg, n, seed=100 + n)
            st = make_param_state(cfg, device=dev)
            for cols, now in zip(batches[:-1], nows[:-1]):
                plain(st, PC.to_device(cols, dev), now, cfg.bucket_ms)
            c, now = PC.to_device(batches[-1], dev), nows[-1]
            st_p = PC.clone_param_state(st)
            admit, _ = kernel(st, c, now, cfg.bucket_ms)  # rolls; then none
            admitted = int(admit.sum())
            kernel_ms = cuda_ms(lambda: kernel(st, c, now, cfg.bucket_ms),
                                50, torch)
            plain_ms = cuda_ms(lambda: plain(st_p, c, now, cfg.bucket_ms),
                               5, torch)
            # the same slot a whole window later: every call finds its start
            # stale and zeroes the current plane
            flip = [now, now + cfg.interval_ms]

            def rolling():
                flip.reverse()
                kernel(st, c, flip[0], cfg.bucket_ms)

            rolling_ms = cuda_ms(rolling, 20, torch)
            rows_in = torch.nonzero(admit)[:, 0]
            pair_ids = ((c["rule_slot"][rows_in].long()[:, None] * cfg.depth
                         + torch.arange(cfg.depth, device=dev)[None, :])
                        * cfg.cell_width + c["idx"][rows_in].long() // 2)
            touched = int(torch.unique(pair_ids).numel())
            nbytes = param_bytes(sketch, n, cfg.depth, cfg.n_buckets,
                                 admitted, touched)
            ops = 40 * n  # a few dozen integer and float ops a row
            bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                           ops / PEAK_F32_OPS_PER_S) * 1e3
            rows[n] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                           bytes=nbytes, admitted=admitted,
                           rolling_ms=rolling_ms)
            log(f"timing {sketch} N={n}: kernel {kernel_ms:.4f} ms "
                f"(rolling {rolling_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.6f} ms ({nbytes} B)")
        out[sketch] = rows
    for n in PARAM_SIZES:
        ratio = out["salsa"][n]["ms"] / out["cms"][n]["ms"]
        log(f"timing N={n}: salsa / cms kernel time {ratio:.3f}")
    return out


def phase_param_service(torch, dev):
    """The hot-param path: a service on the kernel vs one on the torch-ops
    core, per sketch, read through the kernel's launch count. Also returns
    a function that traces more requests of each kernel service (called
    last, as phase 3's profiled pulls are)."""
    from collections import Counter

    import torch_param_check as PC

    from sentinel_tpu_torch.cluster.token_service import (
        ClusterParamFlowRule,
        DefaultTokenService,
    )
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine.param import ParamConfig
    from sentinel_tpu_torch.ops import cms_cuda, salsa_cuda

    counters = {"cms": (cms_cuda.LAUNCHES, "cms_decide_update"),
                "salsa": (salsa_cuda.LAUNCHES, "salsa_decide_update")}
    out, services = {}, {}
    for sketch in SKETCHES:
        mc = clock.ManualClock(1_700_000_000_000)
        prev = clock.set_clock(mc)
        try:
            rng = np.random.default_rng(11)
            specs = PC.service_rule_specs(256, rng)
            reload = PC.reload_specs(specs, rng, n_new=40)
            half = PARAM_REQUESTS // 2
            streams = (PC.service_stream(specs, rng, half),
                       PC.service_stream(reload, rng, half))
            svc = DefaultTokenService(param_config=ParamConfig(sketch=sketch),
                                      device=dev)
            ref = DefaultTokenService(
                param_config=ParamConfig(sketch=sketch, impl="jax"),
                device=dev)

            def rules_of(sp):
                return [ClusterParamFlowRule(s.flow_id, s.count,
                                             s.item_thresholds) for s in sp]

            for s in (svc, ref):
                s.load_param_rules(rules_of(specs))
                s.warmup()
            slots_before = {f: e[0] for f, e in svc._param_rules.items()}
            launches_of, name = counters[sketch]
            advances = itertools.cycle(PARAM_ADVANCES_MS)
            lat, seen = [], Counter()
            t_start = mc.now_ms()
            # --- the main path, read through the launch count ------------
            launches_of.update(dict.fromkeys(launches_of, 0))
            for part, stream in enumerate(streams):
                if part == 1:
                    for s in (svc, ref):
                        s.load_param_rules(rules_of(reload))
                for fid, acq, hashes in stream:
                    t0 = time.perf_counter()
                    got = svc.request_params_token(fid, acq, hashes)
                    lat.append(time.perf_counter() - t0)
                    want = ref.request_params_token(fid, acq, hashes)
                    if got.status != want.status:
                        raise AssertionError(
                            f"{sketch}: param verdict {got.status} != "
                            f"torch-ops core {want.status}")
                    seen[got.status.name] += 1
                    mc.advance(next(advances))
            launches = launches_of[name]
            spanned = mc.now_ms() - t_start
            n_req = sum(len(s) for s in streams)
            if launches != n_req:
                raise AssertionError(
                    f"{sketch} kernel launched {launches} times for {n_req} "
                    f"requests")
            if spanned <= 2 * svc.param_config.interval_ms:
                raise AssertionError(f"the requests spanned {spanned} ms")
            if not (seen["OK"] and seen["BLOCKED"]):
                raise AssertionError(f"{sketch}: verdicts {dict(seen)}")
            for f, a, b in zip(svc._param_state._fields, svc._param_state,
                               ref._param_state):
                if not torch.equal(a, b):
                    raise AssertionError(f"{sketch}: sketch leaf {f} differs")
            slots_after = {f: e[0] for f, e in svc._param_rules.items()}
            freed = set(slots_before.values()) - {
                slots_before[f] for f in slots_before if f in slots_after}
            reused = freed & {slots_after[f] for f in slots_after
                              if f not in slots_before}
            if not reused:
                raise AssertionError("the reload reused no freed slot")
            a = np.array(lat) * 1e3
            out[sketch] = dict(
                launches=launches, requests=n_req,
                p50_ms=float(np.percentile(a, 50)),
                p99_ms=float(np.percentile(a, 99)),
                verdicts=dict(seen))
            log(f"param service {sketch}: {n_req} requests over {spanned} ms"
                f" equal to the torch-ops core, sketches equal; reload freed "
                f"{len(freed)} slots and reused {len(reused)}; {launches} "
                f"kernel launches; verdicts {dict(seen)}; p50 "
                f"{out[sketch]['p50_ms']:.3f} ms, p99 "
                f"{out[sketch]['p99_ms']:.3f} ms a request")
            services[sketch] = (svc, mc, PC.service_stream(
                reload, rng, PROFILED_PARAM_CALLS))
        finally:
            clock.set_clock(prev)

    def profiled_params():
        return {sketch: param_call_kernels(torch, sketch, *services[sketch])
                for sketch in SKETCHES}

    return out, profiled_params


def param_call_kernels(torch, sketch, svc, mc, stream):
    """CUDA kernels a ``request_params_token`` call launches, by name, from
    a ``torch.profiler`` trace of ``stream``'s calls: the param kernel's
    (``csrc/<sketch>.cu``) must be exactly one a call; the torch ops around
    it (host-to-device copies, the slim twin, the verdict) are counted
    apart."""
    from sentinel_tpu_torch.core import clock
    from torch.profiler import ProfilerActivity, profile

    prev = clock.set_clock(mc)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fid, acq, hashes in stream:
                svc.request_params_token(fid, acq, hashes)
                mc.advance(3)
            torch.cuda.synchronize()
    finally:
        clock.set_clock(prev)
    calls = len(stream)
    ours, others = {}, {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA") or not evt.count:
            continue
        mine = f"{sketch}_decide_kernel" in evt.key
        (ours if mine else others)[evt.key] = evt.count
    per_call = {re.search(r"\w+_kernel", k).group(0): v / calls
                for k, v in ours.items()}
    if sum(ours.values()) != calls:
        raise AssertionError(
            f"{sketch}: {calls} profiled calls launched {ours} kernels of "
            f"csrc/{sketch}.cu, not one a call")
    out = dict(calls=calls, param_kernels_a_call=per_call,
               torch_kernels_a_call=sum(others.values()) / calls)
    log(f"param service {sketch}: {calls} profiled calls, kernels of "
        f"csrc/{sketch}.cu a call {per_call}; other CUDA kernels a call "
        f"(torch ops: copies, slim twin, verdict) "
        f"{out['torch_kernels_a_call']:.2f}")
    return out


def outcome_bytes(k: int, k_valid: int, breakers: bool, rolled: bool,
                  n_flows: int, n_channels: int) -> int:
    """Bytes one outcome step must move: the [K] report columns (slot, rt,
    exception, valid) read once; per valid row a read-modify-write of each
    int32 cell it adds to (RT_SUM, COMPLETE, EXCEPTION, the histogram cell,
    and SLOW with breakers); with breakers, per row the flow's cutoff,
    strategy, breaker state and probe ticket read; and, when the bucket
    turns, the current [F, C] column zeroed."""
    cells = 5 if breakers else 4
    nbytes = k * (4 + 4 + 4 + 1) + k_valid * cells * 4 * 2
    if breakers:
        nbytes += k * (4 + 1 + 1 + 4)
    if rolled:
        nbytes += n_flows * n_channels * 4
    return nbytes


def phase_outcome(torch, dev):
    """Completion reports and circuit breaking at full size: the decide
    kernel's service against the torch-ops service on one stream, a lease
    sequence, then the report path's times. Returns the results and a
    function that traces reports (called last)."""
    import torch_kernel_check as DC
    import torch_outcome_check as OC

    from sentinel_tpu_torch.cluster.token_service import DefaultTokenService
    from sentinel_tpu_torch.core import clock
    from sentinel_tpu_torch.engine import (
        ClusterFlowRule,
        DegradeRule,
        DegradeStrategy,
        EngineConfig,
        ThresholdMode,
        outcome_step_donating,
    )
    from sentinel_tpu_torch.engine.state import N_OUTCOME_CHANNELS, make_state
    from sentinel_tpu_torch.ops import decide_cuda as K

    mc = clock.ManualClock(1_700_000_000_040)
    prev = clock.set_clock(mc)
    try:
        cfg = EngineConfig(max_flows=F, max_namespaces=NS,
                           batch_size=SIZES[-1])
        rules = service_rules(ClusterFlowRule, ThresholdMode)
        degrade = [DegradeRule(**{**d, "strategy": DegradeStrategy(
            d["strategy"])}) for d in OC.degrade_specs(
                range(F), lambda fid: f"ns{fid % NS}")]
        svc = DefaultTokenService(cfg, device=dev)
        ref = DefaultTokenService(cfg._replace(decide_impl="xla"),
                                  device=dev)
        for s in (svc, ref):
            s.load_rules(rules, ns_max_qps=1e9)
            s.load_degrade_rules(degrade)
            s.warmup()
        zipf = DC.ZipfIds(F, alpha=1.1)
        rng = np.random.default_rng(31)
        edges = OC.BreakerEdges()
        steps = 0
        verdicts = {}

        def check_op(kind, r, i, n, outs):
            nonlocal steps
            if kind == "pull":
                if not OC.verdicts_equal(outs):
                    raise AssertionError(f"outcome phase: verdicts differ "
                                         f"at round {r} step {i} (n={n})")
                steps += -(-n // cfg.batch_size)
                for code, c in zip(*np.unique(outs[0][0],
                                              return_counts=True)):
                    verdicts[int(code)] = verdicts.get(int(code), 0) + int(c)
            elif outs[0] != outs[1]:
                raise AssertionError(f"outcome phase: report counts "
                                     f"{outs} at round {r} step {i}")
            edges.update(svc.breaker_stats())

        def planes_equal(label):
            bad = [f"{pn}.{f}" for pn, pa, pb in zip(
                       svc._state._fields, svc._state, ref._state)
                   for f, a, b in zip(pa._fields, pa, pb)
                   if not torch.equal(a, b)]
            if bad:
                raise AssertionError(f"outcome phase: {bad} differ {label}")

        def check_round(r):
            planes_equal(f"after round {r}")
            if svc.breaker_stats() != ref.breaker_stats():
                raise AssertionError(f"breaker_stats differ after round {r}")

        # --- the main path, read through the launch count ----------------
        t_start = mc.now_ms()
        K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
        OC.drive((svc, ref), mc.advance, rng, zipf, OUTCOME_PLAN,
                 OUTCOME_ADVANCES_MS, OUTCOME_ROUNDS, check_op, check_round)
        launches = K.LAUNCHES["decide_rows"]
        spanned = mc.now_ms() - t_start
        torch.cuda.synchronize()
        if launches != steps:
            raise AssertionError(f"the decide kernel launched {launches} "
                                 f"times for {steps} device steps")
        if spanned < 8000:
            raise AssertionError(f"the stream spanned only {spanned} ms")
        o_svc, o_ref = svc.outcome_stats(), ref.outcome_stats()
        if o_svc != o_ref:
            raise AssertionError("outcome_stats differ")
        edges.require(trips=3, probes=3, closes=1, reopens=1)
        degraded = verdicts.get(12, 0)
        log(f"outcome: {OUTCOME_ROUNDS} rounds over {spanned} ms, "
            f"{steps} device steps = {launches} decide launches; verdicts "
            f"and report counts equal every step, every plane equal every "
            f"round; breaker edges {edges.counts}; {degraded} DEGRADED "
            f"verdicts; reported {o_svc['reported']}, dropped "
            f"{o_svc['dropped']}, {len(o_svc['flows'])} flows with "
            f"completions in the window")

        # --- leases on 1,000 plain flows ---------------------------------
        lease_ids = [r.flow_id for r in rules
                     if r.control_behavior == 0
                     and r.flow_id % OC.BREAKER_EVERY][:LEASE_FLOWS]

        def both(op, *args):
            a = getattr(svc, op)(*args)
            b = getattr(ref, op)(*args)
            if a != b:
                raise AssertionError(f"{op}{args}: {a} != {b}")
            return a

        grants = [both("lease_grant", fid, 20) for fid in lease_ids]
        ids = np.repeat(np.array(lease_ids, np.int64), 3)
        if not OC.verdicts_equal([s.request_batch_arrays(ids)
                                  for s in (svc, ref)]):
            raise AssertionError("lease pull verdicts differ")
        mc.advance(150)
        renewed = [both("lease_renew", g.lease_id, fid, 3, 10)
                   for g, fid in zip(grants, lease_ids)]
        for g in renewed[::2]:
            both("lease_return", g.lease_id, 1)
        mc.advance(600)  # past the TTL: the other half expires
        stats = both("lease_stats")
        planes_equal("after the lease sequence")
        ok = sum(g.ok for g in grants)
        expired = sum(g.ok for g in renewed[1::2])
        if not ok or stats["revoked"] != expired or stats["outstanding"]:
            raise AssertionError(f"lease sequence: {ok} grants, {expired} "
                                 f"left to expire, {stats}")
        log(f"leases on {len(lease_ids)} flows: {ok} granted, renewed, "
            f"half returned, half expired; equal results and flow planes; "
            f"{stats}")

        # --- report_outcomes on the host clock ---------------------------
        host = {}
        for n in REPORT_SIZES:
            pool = zipf(rng, n)
            lat = []
            for _ in range(30):
                fl, rt, exc = OC.report_rows(rng, pool, n)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                svc.report_outcomes(fl, rt, exc)
                lat.append(time.perf_counter() - t0)
                mc.advance(7)
            torch.cuda.synchronize()
            a = np.array(lat) * 1e3
            host[n] = dict(p50_ms=float(np.percentile(a, 50)),
                           p99_ms=float(np.percentile(a, 99)))
            log(f"report_outcomes n={n}: p50 {host[n]['p50_ms']:.3f} ms, "
                f"p99 {host[n]['p99_ms']:.3f} ms on the host (call only, "
                f"device idle before each call)")

        # --- the outcome step on the device ------------------------------
        # A step is ~100-200 small launches: three steps a timed run keep
        # the host's launch queue from filling while the sleep kernel holds
        # the stream (a full queue paces the device at the host's rate, and
        # the events would time the host); the median of 7 such runs.
        def step_ms(fn):
            return float(np.median([cuda_ms(fn, 3, torch)
                                    for _ in range(7)]))

        step = outcome_step_donating(cfg)
        br = (svc._table.br_strategy, svc._table.br_slow_rt_ms)
        device = {}
        st = make_state(cfg, device=dev)
        for n in REPORT_SIZES:
            fl, rt, exc = OC.report_rows(rng, zipf(rng, n), n)
            slots = svc.lookup_slots(fl)
            valid = (slots >= 0) & np.isfinite(rt) & (rt >= 0) & (
                rt <= OC.OUTCOME_MAX_RT_MS)
            cols = [torch.as_tensor(a, device=dev) for a in (
                np.where(valid, slots, 0).astype(np.int32),
                np.where(valid, rt, 0).astype(np.int32),
                (exc & valid).astype(np.int32), valid)]
            now = [60_040, 60_040 + cfg.n_buckets * cfg.bucket_ms]
            row = {}
            for extra in ((), br):
                # the step makes no call that waits for the device (as far
                # as torch's sync debug mode sees)
                step(st, *cols, now[0], *extra)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    step(st, *cols, now[1], *extra)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            for label, extra in (("no_breakers", ()), ("breakers", br)):
                row[label] = step_ms(
                    lambda: step(st, *cols, now[0], *extra))

                def rolling():
                    now.reverse()
                    step(st, *cols, now[0], *extra)

                row[label + "_rolling"] = step_ms(rolling)
            k_valid = int(valid.sum())
            nbytes = outcome_bytes(n, k_valid, True, False, F,
                                   N_OUTCOME_CHANNELS)
            roll_bytes = outcome_bytes(n, k_valid, True, True, F,
                                       N_OUTCOME_CHANNELS)
            ops = 40 * n  # bucket compares, masks, index math per row
            row.update(
                bytes=nbytes, rolling_bytes=roll_bytes,
                bound_ms=max(nbytes / PEAK_BYTES_PER_S,
                             ops / PEAK_F32_OPS_PER_S) * 1e3,
                rolling_bound_ms=max(roll_bytes / PEAK_BYTES_PER_S,
                                     ops / PEAK_F32_OPS_PER_S) * 1e3,
                no_breakers_bound_ms=outcome_bytes(
                    n, k_valid, False, False, F, N_OUTCOME_CHANNELS)
                / PEAK_BYTES_PER_S * 1e3)
            device[n] = row
            log(f"outcome step K={n}: no synchronizing call; "
                f"{row['breakers']:.4f} ms with the "
                f"breaker columns, {row['no_breakers']:.4f} ms without; a "
                f"step whose bucket turns {row['breakers_rolling']:.4f} / "
                f"{row['no_breakers_rolling']:.4f} ms; bound "
                f"{row['bound_ms']:.6f} ms ({nbytes} B), turning "
                f"{row['rolling_bound_ms']:.6f} ms ({roll_bytes} B)")

        traced_reports = [OC.report_rows(rng, zipf(rng, SIZES[-1]),
                                         SIZES[-1]) for _ in range(5)]

        def profiled_reports():
            """Left to the end: CUDA kernels a 16384-row report launches."""
            before = clock.set_clock(mc)
            try:
                return report_kernels(torch, svc, mc, traced_reports)
            finally:
                clock.set_clock(before)

        out = dict(launches=launches, device_steps=steps, spanned_ms=spanned,
                   edges=dict(edges.counts), lease=stats, host=host,
                   device=device, verdicts=verdicts)
        return out, profiled_reports
    finally:
        clock.set_clock(prev)


def report_kernels(torch, svc, mc, reports):
    """CUDA kernels a ``report_outcomes`` call launches, from a
    ``torch.profiler`` trace of ``reports`` (the outcome step is torch ops;
    no kernel of ``csrc/`` runs in it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fl, rt, exc in reports:
            svc.report_outcomes(fl, rt, exc)
            mc.advance(3)
        torch.cuda.synchronize()
    launched = busy_us = 0.0
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA") and evt.count:
            launched += evt.count
            busy_us += evt.self_device_time_total
    if not launched:
        raise AssertionError("the traced reports launched no CUDA kernel")
    out = dict(reports=len(reports), kernels_a_report=launched / len(reports),
               device_ms_a_report=busy_us / len(reports) / 1e3)
    log(f"report_outcomes n={reports[0][0].size}: {out['kernels_a_report']:.1f}"
        f" CUDA kernels and {out['device_ms_a_report']:.4f} ms of device "
        f"time a report over {len(reports)} traced reports")
    return out


def phase_prefix(torch, dev, cfg, table, state):
    """The segment-prefix plan and apply kernels vs their plain versions on
    every key shape, their times, then an ungrouped decide step with
    prefix_impl="pallas" vs "sort" and the device time of its prefix work."""
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.decide import decide, make_batch
    from sentinel_tpu_torch.ops import prefix_cuda as PK

    rng = np.random.default_rng(5)
    max_err, checked = 0.0, 0
    for n in PREFIX_CHECK_SIZES:
        for shape, keys_np in DC.prefix_key_shapes(rng, n).items():
            keys = torch.as_tensor(keys_np, device=dev)
            contrib = torch.as_tensor(
                rng.integers(0, 4, n).astype(np.float32), device=dev)
            plan = PK.segment_prefix_plan(keys)
            got = PK.segment_prefix_apply(plan, contrib)
            want = PK.segment_prefix_plain(keys, contrib)
            torch.cuda.synchronize()
            if not torch.equal(plan.order,
                               PK.segment_prefix_plan_plain(keys).order):
                raise AssertionError(f"prefix plan != plain at N={n} "
                                     f"({shape})")
            max_err = max(max_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"prefix apply != mask at N={n} "
                                     f"({shape})")
            checked += 1
    log(f"prefix: plan == plain and apply == mask on {checked} key vectors "
        f"(N = {PREFIX_CHECK_SIZES}, shapes {DC.PREFIX_KEY_SHAPES})")

    zipf = DC.ZipfIds(F, alpha=1.1)
    timing = {}
    for n in PREFIX_SIZES:
        keys = torch.as_tensor(zipf(rng, n).astype(np.int32), device=dev)
        contrib = torch.as_tensor(rng.integers(0, 4, n).astype(np.float32),
                                  device=dev)
        plan = PK.segment_prefix_plan(keys)
        plan_ms = cuda_ms(lambda: PK.segment_prefix_plan(keys), 50, torch)
        apply_ms = cuda_ms(lambda: PK.segment_prefix_apply(plan, contrib),
                           50, torch)
        plain_ms = cuda_ms(lambda: PK.segment_prefix_plain(keys, contrib),
                           5, torch)
        nbytes = 12 * n  # a call reads key and contribution, writes out
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       n / PEAK_F32_OPS_PER_S) * 1e3
        timing[n] = dict(ms=apply_ms, plan_ms=plan_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms)
        log(f"prefix N={n}: apply {apply_ms:.4f} ms, plan {plan_ms:.4f} ms, "
            f"plain (mask) {plain_ms:.4f} ms, bound {bound_ms:.6f} ms a call")

    # one ungrouped decide step at F=100k, after two steps that fill state
    n = SIZES[-1]
    c_pal = cfg._replace(batch_size=n, prefix_impl="pallas")
    c_sort = c_pal._replace(prefix_impl="sort")

    def pull():
        slots = zipf(rng, n).astype(np.int32)
        slots[rng.choice(n, size=n // 100, replace=False)] = -1
        return make_batch(c_pal, slots, rng.integers(1, 4, n),
                          rng.random(n) < 0.1)

    st = state
    for now in (60_010, 60_160):
        st, _ = decide(c_sort, st, table, pull(), now)
    batch, now = pull(), 60_420
    PK.LAUNCHES.update(dict.fromkeys(PK.LAUNCHES, 0))
    plans, applies = [], []
    plan_fn, apply_fn = PK.segment_prefix_plan, PK.segment_prefix_apply

    def plan_rec(keys):
        plans.append(keys)
        return plan_fn(keys)

    def apply_rec(plan, contrib):
        applies.append(contrib.to(torch.float32).clone())
        return apply_fn(plan, contrib)

    PK.segment_prefix_plan, PK.segment_prefix_apply = plan_rec, apply_rec
    try:
        st_p, v_p = decide(c_pal, st, table, batch, now)
    finally:
        PK.segment_prefix_plan, PK.segment_prefix_apply = plan_fn, apply_fn
    torch.cuda.synchronize()
    launches = dict(PK.LAUNCHES)
    st_s, v_s = decide(c_sort, st, table, batch, now)
    if launches["segment_prefix_plan"] != 1 or \
            launches["segment_prefix_apply"] < 1:
        raise AssertionError(f"the pallas decide step launched {launches}")
    pairs = [(f"verdict.{f}", a, b) for f, a, b in zip(v_p._fields, v_p, v_s)]
    pairs += [(f"state.{pn}.{f}", a, b)
              for pn, pa, pb in zip(st_p._fields, st_p, st_s)
              for f, a, b in zip(pa._fields, pa, pb)]
    bad = [label for label, a, b in pairs if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"pallas decide != sort decide: {bad}")

    def step_prefix():
        plan = PK.segment_prefix_plan(plans[0])
        for contrib in applies:
            PK.segment_prefix_apply(plan, contrib)

    step_ms = cuda_ms(step_prefix, 20, torch)
    ok = int((v_p.status == 0).sum())
    log(f"ungrouped decide N={n}: prefix_impl pallas == sort in verdicts "
        f"and every state leaf; prefix launches {launches}; {ok} rows OK; "
        f"the step's prefix work (1 plan, {len(applies)} applies) "
        f"{step_ms:.4f} ms on the device")
    return launches, max_err, timing, step_ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import sentinel_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script: {exc}",
              file=sys.stderr)
        return 3
    from sentinel_tpu_torch.engine import EngineConfig, build_rule_table
    from sentinel_tpu_torch.engine.state import make_state, state_nbytes
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_check as DC

    from sentinel_tpu_torch.ops import _build

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    cfg = EngineConfig(max_flows=F, max_namespaces=NS, batch_size=SIZES[-1])
    rng = np.random.default_rng(1)
    table, index = build_rule_table(cfg, DC.mixed_rules(F, NS, rng),
                                    ns_max_qps=1e9,
                                    connected={"ns1": 4}, device=dev)
    state = make_state(cfg, device=dev)
    log(f"device state: {state_nbytes(state)} B at F={F}, B={B}")

    max_err, checked = phase_parity(torch, dev, cfg, table, state)
    timing = phase_timing(torch, dev, cfg, table, state)
    launches, service, profiled_pulls = phase_service(torch, dev)
    param_parity = phase_param_parity(torch, dev)
    param_timing = phase_param_timing(torch, dev)
    param_service, profiled_params = phase_param_service(torch, dev)
    prefix_launches, prefix_err, prefix_timing, step_ms = phase_prefix(
        torch, dev, cfg, table, state)
    outcome, profiled_reports = phase_outcome(torch, dev)
    service[SIZES[-1]].update(profiled_pulls())
    for sketch, kernels_a_call in profiled_params().items():
        param_service[sketch]["profiled"] = kernels_a_call
    outcome["profiled"] = profiled_reports()

    ident = gpu_identity()
    main_n = SIZES[-1]
    kernels = [{
        "name": "decide_rows",
        "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/decide.cu",
        "replaces": "sentinel_tpu/ops/decide_pallas.py:88",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing[main_n]["ms"],
        "plain_ms": timing[main_n]["plain_ms"],
        "bound_ms": timing[main_n]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "parity_steps": checked,
        "by_n": {str(n): timing[n] for n in SIZES},
        "launches_outcome_phase": outcome["launches"],
    }]
    for sketch, name, line in (("cms", "cms_decide_update", 49),
                               ("salsa", "salsa_decide_update", 37)):
        main_row = param_timing[sketch][PARAM_SIZES[0]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"sentinel_tpu_torch/csrc/{sketch}.cu",
            "replaces": f"sentinel_tpu/ops/{sketch}_pallas.py:{line}",
            "launches": param_service[sketch]["launches"],
            "max_abs_err": param_parity[sketch][0],
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "rolling_ms": main_row["rolling_ms"],
            "parity_steps": param_parity[sketch][1],
            "by_n": {str(n): v for n, v in param_timing[sketch].items()},
        })
    main_row = prefix_timing[PREFIX_SIZES[-1]]
    kernels.append({
        "name": "segment_prefix",
        "route": "cuda",
        "source": "sentinel_tpu_torch/csrc/prefix.cu",
        "replaces": "sentinel_tpu/ops/prefix_pallas.py:32",
        "launches": prefix_launches["segment_prefix_apply"],
        "plan_launches": prefix_launches["segment_prefix_plan"],
        "max_abs_err": prefix_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "plan_ms": main_row["plan_ms"],
        "step_ms": step_ms,
        "by_n": {str(n): v for n, v in prefix_timing.items()},
    })
    log(json.dumps({"service": {str(n): v for n, v in service.items()},
                    "param_service": param_service,
                    "outcome": outcome,
                    "gpu": ident}))
    log(ident)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
