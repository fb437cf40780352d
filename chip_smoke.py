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
   (``tests/torch_kernel_check.py`` holds the workloads);
2. times the kernel and the plain version at those N with CUDA events;
3. drives the service path at full size: ``DefaultTokenService`` with 100k
   flow rules (a shaped subset among them), warmed up, answering
   bounded-Zipf (alpha 1.1) pulls of 64, 1024, 16384 and 65536 rows (the
   last takes the fused depth-4 path) over more than three seconds of
   engine clock; its verdicts must equal those of a second service on the
   torch-ops pipeline, fed the same pulls at the same engine clock, and the
   kernel's launch count must rise by exactly one per device step;
4. prints the timings, the card's name and power limit, one
   ``{"kernels": [...]}`` line, and last ``{"ok": true, "device": ...}``.

Any failed check raises and exits non-zero. With no CUDA device, or run from
a directory without the package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
F, NS, B = 100_000, 64, 10
SIZES = (64, 1024, 16384)  # the serve ladder's ends and middle
PULLS = (64, 1024, 16384, 65536)  # the last: 4 full frames, fused depth 4
FUSED_DEPTH = 4
# engine-clock ms between served pulls, cycled: same bucket, a roll, a
# short step and a near-full window, so each round spans 1.1 s of the ring
ADVANCES_MS = (5, 130, 45, 930)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32, outside the tensor cores


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
                c, table, state, batches, nows, uniform)
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
            log(f"parity N={n} uniform={uniform}: {len(nows)} steps "
                f"bitwise equal, ring wrapped onto written columns; "
                f"verdicts {hist}")
    return max_err, checked


def phase_timing(torch, dev, cfg, table, state):
    """Kernel and plain-version ms per step, with the byte bound."""
    import torch_kernel_check as DC

    from sentinel_tpu_torch.engine.state import clone_state
    from sentinel_tpu_torch.ops import decide_cuda as K

    rng = np.random.default_rng(7)
    zipf = DC.ZipfIds(F, alpha=1.1)
    rows = {}
    for n in SIZES:
        c = cfg._replace(batch_size=n)
        batch = DC.grouped_batch(c, rng, zipf, n, uniform=True,
                                 unknown=max(1, n // 100))
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
        rows[n] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       wall_ms=kernel_wall, bytes=nbytes,
                       rows_touched=touched)
        log(f"timing N={n}: kernel {kernel_ms:.4f} ms on the device "
            f"({kernel_wall:.4f} ms a call with host launch), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
            f"({nbytes} B, {touched} distinct flows)")
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
        return launches, stats
    finally:
        clock.set_clock(prev)


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
    launches, service = phase_service(torch, dev)

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
    }]
    log(json.dumps({"service": {str(n): v for n, v in service.items()},
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
